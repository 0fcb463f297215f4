"""Bandwidth of each fusion mode: the mean megabytes one ego sample receives.

Counterpart of ``workspace/measure_exchange_size.py``, with its byte rules,
its CLI and its JSON keys:

* early fusion: every other agent's raw points, 7 float32 a point;
* late fusion: the MoDAR boxes of the exchange database, 9 float32 a box;
  lately fusion: each box with its pooled flow (the boxflow wire format),
  12 float32 a box, or under a legacy database the boxes and the
  foreground points (9 and 13 float32 a row);
* mid fusion (DiscoNet): one agent's broadcast BEV image, 384 channels on
  the 128x128 stride-4 grid, in float32.

The early and lately figures read the first ``max_samples`` test samples'
``metadata["exchange"]`` through the port's datasets.

    python -m pcp_tpu_torch.workspace.measure_exchange_size --synthetic \
        [--json results/<tag>_torch/bandwidth.json] [--set KEY VALUE ...]

``--set`` takes DATA_CONFIG overrides as KEY VALUE pairs
(``EXCHANGE_DATABASE_DIRECTORY`` names the database to read).
"""
import argparse
import json
from pathlib import Path

import numpy as np

from ..config import ROOT_DIR, CfgDict, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..utils.common_utils import create_logger
from .v2x_gen_exchange_database import data_overrides

CFGS = ROOT_DIR / "tools" / "cfgs" / "v2x_sim_models"


def _exchanges(cfg_name, cfg_overrides, max_samples):
    """``metadata["exchange"]`` of the first ``max_samples`` test samples of
    the config ``cfg_name``, in order."""
    cfg = cfg_from_yaml_file(CFGS / f"{cfg_name}.yaml", CfgDict())
    if cfg_overrides:
        cfg.DATA_CONFIG.update(cfg_overrides)
    _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=1,
                                    training=False, logger=create_logger(), workers=0)
    out = []
    for batch in loader:
        out.append(batch["metadata"][0]["exchange"])
        if len(out) >= max_samples:
            break
    return out


def _mb(sizes):
    return float(np.mean(sizes)) / 1e6 if sizes else 0.0


def measure_early(cfg_overrides=None, max_samples=32):
    """Early fusion: the other agents' raw points, 7 float32 a point."""
    return _mb([sum(ex.values()) * 7 * 4
                for ex in _exchanges("v2x_pointpillar_basic_ego_early", cfg_overrides,
                                     max_samples)])


def measure_lately(cfg_overrides=None, max_samples=32):
    """(late, lately) fusion: the boxes alone, 9 float32 a box; the boxes
    with their pooled flow, 12 float32 a box, or under a legacy database
    (foreground rows read) the boxes and the foreground points, 13 float32
    a point."""
    late, lately = [], []
    for ex in _exchanges("v2x_pointpillar_basic_ego", cfg_overrides, max_samples):
        n_fg = sum(v[0] for v in ex.values())
        n_modar = sum(v[1] for v in ex.values())
        late.append(n_modar * 9 * 4)
        lately.append(n_modar * 12 * 4 if n_fg == 0 else n_modar * 9 * 4 + n_fg * 13 * 4)
    return _mb(late), _mb(lately)


def measure_mid(bev_channels=384, bev_hw=128):
    """Mid fusion: one agent's broadcast BEV image (the maker's backbone
    output; the ego compresses it to 128 channels on its side)."""
    return bev_hw * bev_hw * bev_channels * 4 / 1e6


def main(argv=None):
    parser = argparse.ArgumentParser(description="the bandwidth of each fusion mode")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="DATA_CONFIG overrides as KEY VALUE pairs")
    parser.add_argument("--json", default=None, help="also write the figures to this JSON file")
    args = parser.parse_args(argv)
    overrides = {"USE_SYNTHETIC_DATA": True} if args.synthetic else {}
    overrides.update(data_overrides(args.set_cfgs) or {})
    overrides = overrides or None
    late_mb, lately_mb = measure_lately(overrides)
    early_mb, mid_mb = measure_early(overrides), measure_mid()
    print(f"early fusion:  {early_mb:.3f} MB/sample")
    print(f"late fusion:   {late_mb:.4f} MB/sample")
    print(f"lately fusion: {lately_mb:.4f} MB/sample")
    print(f"mid (Disco):   {mid_mb:.2f} MB/sample")
    out = {"early_MB": round(early_mb, 4), "late_MB": round(late_mb, 5),
           "lately_MB": round(lately_mb, 5), "mid_disco_MB": round(mid_mb, 3),
           "protocol": "workspace/measure_exchange_size.py's rules on the port's datasets; "
                       "mid = one agent's 384ch stride-4 bev_img"}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
