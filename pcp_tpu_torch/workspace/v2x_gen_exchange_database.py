"""Exchange-database generator: the broadcast step of lately fusion.

Counterpart of ``workspace/v2x_gen_exchange_database.py``: runs a trained
car or RSU sender over both splits (train, then val) with augmentation off,
every sample once and in order, and writes each cloud's MoDAR boxes, its
foreground points with their flow and the boxes' pooled flow into the
exchange database (the files are the V2X channel). ``--agent second_car`` and
``second_rsu`` are the SECOND senders of the heterogeneous-network variant
(``v2x_second_{car,rsu}.yaml``), whose database is
``exchange_database_second``, the one ``v2x_second_ego.yaml`` reads.

    python -m pcp_tpu_torch.workspace.v2x_gen_exchange_database --agent car \
        --ckpt <checkpoint_epoch_n.pth> --synthetic [--out_dir DIR] \
        [--broadcast_score_thresh 0.03 --broadcast_post_max 200] [--device cuda] \
        [--set KEY VALUE ...]

``--set`` takes DATA_CONFIG overrides as KEY VALUE pairs. The database goes
to ``--out_dir``, else to ``DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY`` under
the data root (an absolute path stands as given): ``exchange_database_flow``
for the pillar senders, ``exchange_database_second`` for the SECOND ones.
"""
import argparse
import ast

import torch

from ..config import ROOT_DIR, CfgDict, cfg_from_yaml_file
from ..datasets import build_dataloader
from ..datasets.loader import DataLoader
from ..exchange.database import ExchangeDatabase
from ..models import DatasetInfo, build_network
from ..train.checkpoint import load_params_from_file
from ..train.eval_utils import make_exchange_writer
from ..train.train_utils import _to_device_batch
from ..utils.common_utils import create_logger

AGENT_CFGS = {
    "car": ROOT_DIR / "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml",
    "rsu": ROOT_DIR / "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_rsu.yaml",
    "second_car": ROOT_DIR / "tools/cfgs/v2x_sim_models/v2x_second_car.yaml",
    "second_rsu": ROOT_DIR / "tools/cfgs/v2x_sim_models/v2x_second_rsu.yaml",
}
# the database each sender writes unless DATA_CONFIG or --out_dir names another
EXCHANGE_DIRS = {"car": "exchange_database_flow", "rsu": "exchange_database_flow",
                 "second_car": "exchange_database_second", "second_rsu": "exchange_database_second"}

BATCH_SIZE = 2


def gen_exchange_database(agent="car", ckpt=None, synthetic=False, out_dir=None,
                          cfg_overrides=None, logger=None, state_dict=None,
                          broadcast_score_thresh=None, broadcast_post_max=None, device="cuda",
                          workers=2):
    """Broadcast ``agent``'s outputs over the train and the test split. The
    weights come from ``state_dict`` or ``ckpt``. ``broadcast_score_thresh`` and
    ``broadcast_post_max`` loosen the sender's post-processing for the
    broadcast. Returns {split: clouds written}."""
    logger = logger or create_logger()
    if state_dict is None and ckpt is None:
        raise ValueError("gen_exchange_database needs trained weights: give ckpt or state_dict")
    cfg = cfg_from_yaml_file(AGENT_CFGS[agent], CfgDict())
    pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    if broadcast_score_thresh is not None:
        pp["SCORE_THRESH"] = float(broadcast_score_thresh)
    if broadcast_post_max is not None:
        pp.NMS_CONFIG["NMS_POST_MAXSIZE"] = int(broadcast_post_max)
    # generation runs with augmentation and downsampling off
    cfg.DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST = [
        c["NAME"] for c in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST]
    cfg.DATA_CONFIG["DATASET_DOWNSAMPLING_RATIO"] = 1
    if synthetic:
        cfg.DATA_CONFIG["USE_SYNTHETIC_DATA"] = True
    cfg.DATA_CONFIG.setdefault("EXCHANGE_DATABASE_DIRECTORY", EXCHANGE_DIRS[agent])
    if cfg_overrides:
        cfg.DATA_CONFIG.update(cfg_overrides)

    device = torch.device(device)
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset_info=info,
                          device=device)
    model.load_state_dict(state_dict if state_dict is not None else load_params_from_file(ckpt),
                          strict=True)
    model.eval()
    thresh = float(cfg.MODEL.CORRECTOR.get("THRESHOLD_POINT_CLS_PROB", 0.3))

    written = {}
    for split in ("train", "test"):
        # built with training=<split> so that it reads that split's infos,
        # then switched to evaluation (no augmentation, no resampling) and
        # read in order, every sample once
        ds, _, _ = build_dataloader(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                                    batch_size=BATCH_SIZE, workers=0, logger=logger,
                                    training=split == "train")
        ds.training = False
        loader = DataLoader(ds, batch_size=BATCH_SIZE, shuffle=False, drop_last=False,
                            num_workers=workers, pin_memory=device.type == "cuda")
        exch_dir = out_dir or (ds.root_path / cfg.DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY)
        writer = make_exchange_writer(ExchangeDatabase(exch_dir), bg_prob_thresh=thresh)
        n = 0
        with torch.inference_mode():
            for batch in loader:
                writer(batch, model(_to_device_batch(batch, device)))
                n += int(batch["batch_size"])
        written[split] = n
        logger.info(f"exchange data written for split={split}: {n} clouds -> {exch_dir}")
    return written


def data_overrides(pairs):
    """DATA_CONFIG overrides from ``--set`` KEY VALUE pairs, each value
    read as a Python literal where it is one; None for no pairs."""
    if not pairs:
        return None
    if len(pairs) % 2:
        raise ValueError(f"--set expects KEY VALUE pairs, got {pairs}")
    overrides = {}
    for k, v in zip(pairs[0::2], pairs[1::2]):
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    return overrides


def main(argv=None):
    parser = argparse.ArgumentParser(description="write a sender's exchange database")
    parser.add_argument("--agent", choices=sorted(AGENT_CFGS), default="car")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--broadcast_score_thresh", type=float, default=None)
    parser.add_argument("--broadcast_post_max", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="DATA_CONFIG overrides as KEY VALUE pairs")
    args = parser.parse_args(argv)
    return gen_exchange_database(args.agent, args.ckpt, args.synthetic, args.out_dir,
                                 cfg_overrides=data_overrides(args.set_cfgs),
                                 broadcast_score_thresh=args.broadcast_score_thresh,
                                 broadcast_post_max=args.broadcast_post_max, device=args.device,
                                 workers=args.workers)


if __name__ == "__main__":
    main()
