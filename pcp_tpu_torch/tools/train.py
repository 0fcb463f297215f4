"""Training CLI of the port: counterpart of ``tools/train.py``.

    python -m pcp_tpu_torch.tools.train --cfg_file tools/cfgs/v2x_sim_models/<cfg>.yaml \
        [--batch_size 4] [--epochs 20] [--extra_tag tag] [--seed 0] [--device cuda] \
        [--set DATA_CONFIG.USE_SYNTHETIC_DATA True ...]
    torchrun --nproc_per_node N -m pcp_tpu_torch.tools.train --launcher pytorch ...

Writes ``{output_root}/{EXP_GROUP}/{TAG}/{extra_tag}/``: ``ckpt/`` (rotating
``checkpoint_epoch_{n}.pth``), the log, each step's loss, loss terms and
gradient norm (``train_history_{stamp}.json``) and, with ``--profile``, a
``torch.profiler`` trace of part of one epoch with its summary. DiscoNet's
frozen BEV makers take the weights of the single-agent checkpoints their
``MODEL.BEV_MAKER_*.CKPT`` name once the state is built. It resumes
from ``--ckpt`` or the newest checkpoint there, then trains the remaining
epochs (``train/train_utils.py::train_model``) and, with
``--num_epochs_to_eval`` > 0, evaluates the last checkpoints
(``tools/test.py::repeat_eval_ckpt``). The model runs on ``--device``
(default ``cuda``: raises where there is no GPU). With ``--launcher
pytorch`` the process is one rank of a data-parallel run (pcdet's flag;
``torchrun`` starts the ranks and sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and the rendezvous): NCCL between cards (rank r on
``cuda:LOCAL_RANK``), gloo with ``--device cpu``. ``--batch_size`` stays the
global batch; each rank takes its share (``datasets/loader.py``), the step
is the one-process step over the global batch (``train/train_state.py``;
the ego only, ROADMAP A10b), and rank 0 alone logs, saves and writes the
evaluation's files.
"""
import argparse
import datetime
import json
import os
import statistics
from pathlib import Path

import torch

from ..config import ROOT_DIR, CfgDict, cfg_from_list, cfg_from_yaml_file, log_config_to_file
from ..datasets import build_dataloader
from ..models import DatasetInfo, build_network
from ..models.detectors.detector_template import MAKER_KEYS
from ..ops import bev_scatter
from ..parallel import barrier, process_group, replicate_state
from ..train.checkpoint import latest_checkpoint, load_checkpoint, overlay_bev_maker_weights
from ..train.optimization import build_optimizer
from ..train.train_state import create_train_state
from ..train.train_utils import train_model
from ..utils.common_utils import create_logger, set_random_seed

OUTPUT_ROOT = ROOT_DIR / "output" / "torch"


def add_common_args(parser):
    """The flags the train and test CLIs share."""
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--output_root", type=str, default=str(OUTPUT_ROOT),
                        help="root of the output tree (default output/torch)")
    parser.add_argument("--tf32", choices=("on", "off"), default="on",
                        help="TF32 in cuDNN's convolutions (PyTorch's default: on); off also "
                             "keeps it out of matmuls")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)


def apply_tf32(setting):
    """``--tf32 off``: float32 convolutions and matmuls on the card, without
    TF32; ``on`` leaves PyTorch's defaults."""
    if setting == "off":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def load_cfg(args):
    """The config of ``args.cfg_file`` (a relative path that does not exist
    is taken from the repository root) with ``--set`` applied, its TAG and
    EXP_GROUP_PATH, and the output directory of this run."""
    path = Path(args.cfg_file)
    if not path.is_absolute() and not path.exists():
        path = ROOT_DIR / path
    cfg = cfg_from_yaml_file(path, CfgDict())
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = "/".join(args.cfg_file.split("/")[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    output_dir = Path(args.output_root) / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    return cfg, output_dir


def resolve_maker_ckpt(path):
    """A BEV maker's ``CKPT``: an absolute path as given; a relative one
    with its leading ``../`` and ``./`` stripped, taken from the repository
    root, so that nothing outside the checkout is read."""
    ckpt = Path(str(path))
    if ckpt.is_absolute():
        return ckpt
    stripped = str(path)
    while stripped.startswith("../") or stripped.startswith("./"):
        stripped = stripped.split("/", 1)[1]
    return ROOT_DIR / stripped


def overlay_makers(model, model_cfg, logger):
    """DiscoNet's frozen makers take the weights of the single-agent
    checkpoints their ``CKPT`` names; a missing file leaves the maker's
    seeded weights, with a warning, as the JAX CLI does."""
    for key in MAKER_KEYS:
        mk_cfg = model_cfg.get(key)
        if mk_cfg is None or not mk_cfg.get("CKPT"):
            continue
        ckpt = resolve_maker_ckpt(mk_cfg["CKPT"])
        if not ckpt.exists():
            logger.warning(f"{key}.CKPT not found: {mk_cfg['CKPT']} -- maker stays random")
            continue
        overlay_bev_maker_weights(model, key.lower(), ckpt, logger=logger)


def build_model(cfg, device):
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    return build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset_info=info,
                         device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train a detector of the port")
    add_common_args(parser)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--fix_random_seed", action="store_true", default=False)
    parser.add_argument("--seed", type=int, default=None,
                        help="training seed (weights, batch order, every item's draws); "
                             "overrides --fix_random_seed")
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--ckpt_save_time_interval", type=int, default=300,
                        help="seconds between overwriting the 'latest_model' snapshot")
    parser.add_argument("--precise_bn", type=int, default=30,
                        help="bake BN statistics averaged over N train batches into the last "
                             "checkpoint (0 = off)")
    parser.add_argument("--precise_bn_every", type=int, default=0,
                        help="also bake every Nth epoch's checkpoint (0 = the last only)")
    parser.add_argument("--num_epochs_to_eval", type=int, default=15,
                        help="evaluate the last N epochs' checkpoints after training (0 = off)")
    parser.add_argument("--max_waiting_mins", type=int, default=0)
    parser.add_argument("--infer_time", action="store_true", default=False)
    parser.add_argument("--profile", action="store_true",
                        help="trace steps 1-10 of the second epoch (or the only one) with "
                             "torch.profiler")
    parser.add_argument("--launcher", choices=("none", "pytorch"), default="none",
                        help="pytorch: one rank of a data-parallel run started by torchrun")
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns a summary: steps, epochs run, the losses, the median
    data and step milliseconds a batch, and the kernels' launches."""
    args = parse_args(argv)
    if args.launcher == "none":
        return train(args, torch.device(args.device))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    with process_group(rank, world, "env://", "nccl" if device.type == "cuda" else "gloo",
                       device):
        return train(args, device, rank)


def train(args, device, rank=0):
    """``main`` on ``device``, as ``rank`` of the process group if there is
    one."""
    cfg, output_dir = load_cfg(args)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    ckpt_dir = output_dir / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    logger = create_logger(output_dir / f"log_train_{stamp}.txt" if rank == 0 else None,
                           rank=rank)
    logger.info("**********************Start logging**********************")
    apply_tf32(args.tf32)
    if device.type == "cuda":
        logger.info(f"device: {torch.cuda.get_device_name(device)}, torch {torch.__version__}, "
                    f"TF32 in cuDNN {torch.backends.cudnn.allow_tf32}, "
                    f"in matmuls {torch.backends.cuda.matmul.allow_tf32}")
    log_config_to_file(cfg, logger=logger)
    seed = args.seed if args.seed is not None else (666 if args.fix_random_seed else 0)
    if args.seed is not None or args.fix_random_seed:
        set_random_seed(seed)
    logger.info(f"training seed: {seed}")

    model = build_model(cfg, device)
    train_set, train_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
        workers=args.workers, seed=seed, logger=logger, training=True,
        pin_memory=device.type == "cuda")
    optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, len(train_loader), epochs)
    state = create_train_state(model, optimizer, seed)
    logger.info(f"model parameters: {sum(p.numel() for p in model.parameters())}")
    overlay_makers(model, cfg.MODEL, logger)

    start_epoch = 0
    resume_from = args.ckpt or latest_checkpoint(ckpt_dir)
    if resume_from is not None:
        state, start_epoch, _ = load_checkpoint(resume_from, state)
        logger.info(f"resumed from {resume_from} (epoch {start_epoch})")
    replicate_state(state)

    history = []
    bev_scatter.reset_launches()
    logger.info("**********************Start training**********************")
    train_model(state, train_loader, epochs, ckpt_dir, logger=logger,
                max_ckpt_save_num=args.max_ckpt_save_num, start_epoch=start_epoch,
                profile_dir=(output_dir / "profile") if args.profile else None,
                profile_epoch=min(start_epoch + 1, epochs - 1), profile_steps=(1, 11),
                ckpt_save_time_interval=args.ckpt_save_time_interval,
                precise_bn_batches=args.precise_bn, precise_bn_every=args.precise_bn_every,
                history=history)
    if rank == 0:
        (output_dir / f"train_history_{stamp}.json").write_text(json.dumps(history))
    launches = dict(bev_scatter.launches)
    summary = {"steps": len(history), "epochs": epochs - start_epoch,
               "losses": [h["loss"] for h in history], "launches": launches,
               "data_ms_median": statistics.median(h["data_ms"] for h in history) if history else None,
               "step_ms_median": statistics.median(h["step_ms"] for h in history) if history else None}
    logger.info(f"trained {summary['steps']} steps in {summary['epochs']} epochs: median data "
                f"{summary['data_ms_median']} ms, step {summary['step_ms_median']} ms a batch; "
                f"kernel launches {launches}")
    logger.info("**********************Training done**********************")

    if args.num_epochs_to_eval > 0:
        from .test import repeat_eval_ckpt

        barrier()  # every rank sees rank 0's last checkpoint
        logger.info("**********************Start evaluation**********************")
        test_set, test_loader, _ = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
            workers=args.workers, logger=logger, training=False,
            pin_memory=device.type == "cuda")
        args.start_epoch = max(epochs - args.num_epochs_to_eval, 0)
        args.ckpt, args.ckpt_dir, args.bn_recal = None, str(ckpt_dir), 0
        repeat_eval_ckpt(model, test_set, test_loader, args, cfg,
                         output_dir / "eval" / "eval_with_train", logger, ckpt_dir)
        logger.info("**********************End evaluation**********************")
    return summary


if __name__ == "__main__":
    main()
