"""The BF16 ego's data-parallel step against one process, over several seeds.

    python3 tools_torch/bf16_rank_spread.py [--seeds 0 1 2 3] [--variance two_pass|fast]

For each seed, chip_smoke.py's phase-12 arrangement for the full-width ego
under ``MODEL.BF16`` alone: two spawned gloo ranks sharing the card
(``_dp_rank``) against the one-process step over the same b2 x 32768
batch, standard and rounding as the ranks do (``_like_ranks``); prints
``dp_errors``' loss, terms, statistics, gradient L2, worst entry and worst
leaf norm of each comparison. ``--variance fast`` swaps the BF16 BN's
two-pass batch variance for flax's E[x^2] - E[x]^2 in every process, to
tell the formula's share of the spread from bfloat16's. Needs one card;
imports no JAX.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from pcp_tpu_torch.models.model_utils import norm  # noqa: E402


def _fast_variance_forward(self, x):
    """``BatchNorm2d._global_batch_forward`` in BF16 with flax's fast
    variance, clipped at 0."""
    c = x.shape[1]
    x = x.float()
    sums = norm.all_reduce_sum(torch.cat([norm.rank_sum(x, (0, 2, 3)),
                                          norm.rank_sum(x * x, (0, 2, 3)),
                                          x.new_full((1,), x.numel() // c)]))
    mean = sums[:c] / sums[2 * c]
    var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * var)
    mul = (torch.rsqrt(var + self.eps) * self.weight)[:, None, None]
    return ((x - mean[:, None, None]) * mul + self.bias[:, None, None]).to(self.compute_dtype)


# the spawned ranks import this file again: the environment carries the choice
if os.environ.get("BF16_RANK_SPREAD_VARIANCE") == "fast":
    norm.BatchNorm2d._global_batch_forward = _fast_variance_forward


def main():
    from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
    from pcp_tpu_torch.models import DatasetInfo

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--variance", choices=["two_pass", "fast"], default="two_pass")
    args = ap.parse_args()
    os.environ["BF16_RANK_SPREAD_VARIANCE"] = args.variance
    if args.variance == "fast":
        norm.BatchNorm2d._global_batch_forward = _fast_variance_forward
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cs.phase_device()
    cs.phase_build()
    cfg = cfg_from_yaml_file(cs.CFG_EGO, CfgDict())
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    (REPO / "build").mkdir(exist_ok=True)
    for seed in args.seeds:
        host = cs.train_batch(np.random.default_rng(seed + 5), cs.DP_B, cs.N, info)
        one = cs._dp_step("ego_bf16", seed, host, "cuda")
        like = cs._dp_step("ego_bf16", seed, host, "cuda", like_ranks=True)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            torch.multiprocessing.spawn(cs._dp_rank, args=(seed, tmp, {"ego_bf16": host}, {}),
                                        nprocs=cs.DP_WORLD, join=True)
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                     ["ego_bf16 torch.float32"] for r in range(cs.DP_WORLD)]
        for what, ref in (("vs one process", one), ("vs one process like ranks", like)):
            e = cs.dp_errors(ref, ranks)
            print(f"{args.variance} seed {seed} {what}: loss {e['loss']:.3e} terms {e['tb']:.3e} "
                  f"stats {e['stats']:.3e} grad_l2 {e['grad_l2']:.3e} entry {e['grad_entry']:.3e} "
                  f"({e['grad_worst_leaf']}) norm {e['grad_norm']:.3e} ({e['grad_norm_leaf']})",
                  flush=True)


if __name__ == "__main__":
    main()
