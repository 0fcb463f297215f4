"""Evaluation CLI of the port: counterpart of ``tools/test.py``.

    python -m pcp_tpu_torch.tools.test --cfg_file tools/cfgs/v2x_sim_models/<cfg>.yaml \
        --ckpt <checkpoint_epoch_n.pth> [--eval_tag tag] [--infer_time] [--bn_recal N] \
        [--device cuda] [--set ...]

Evaluates one checkpoint (``eval_single_ckpt``), or with ``--eval_all`` each
new checkpoint of ``--ckpt_dir`` in epoch order (``repeat_eval_ckpt``,
polling for up to ``--max_waiting_mins``); late fusion
(``v2x_late_fusion.yaml``, a host model) takes no checkpoint. Each
evaluation writes its log, ``metrics_summary.json`` and ``metrics.json`` (the
numeric results under the JAX package's keys) under
``{output_root}/{EXP_GROUP}/{TAG}/{extra_tag}/eval/[{eval_tag}/]``. A config that sets ``GENERATING_EXCHANGE_DATA`` broadcasts
the outputs into its ``DATABASE_EXCHANGE_DATA`` directory.
"""
import argparse
import datetime
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from ..datasets import build_dataloader
from ..exchange.database import ExchangeDatabase
from ..train.bn_recal import recalibrate_batch_stats
from ..train.checkpoint import latest_checkpoint, load_params_from_file
from ..train.eval_utils import eval_one_epoch, make_exchange_writer
from ..train.train_utils import _to_device_batch
from ..utils.common_utils import create_logger
from .train import add_common_args, apply_tf32, build_model, load_cfg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate a detector of the port")
    add_common_args(parser)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true", default=False,
                        help="evaluate every (new) checkpoint in --ckpt_dir")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--eval_tag", type=str, default="default",
                        help="subdirectory under eval/ for this evaluation")
    parser.add_argument("--infer_time", action="store_true", default=False)
    parser.add_argument("--bn_recal", type=int, default=0, metavar="N",
                        help="recalibrate the BN running statistics over N train batches "
                             "before evaluating (0 = off)")
    return parser.parse_args(argv)


def exchange_writer_from_cfg(cfg, logger):
    """The exchange writer where the config's DENSE_HEAD or CORRECTOR sets
    ``GENERATING_EXCHANGE_DATA``, else None."""
    db_path = None
    gen = False
    for section in ("DENSE_HEAD", "CORRECTOR"):
        sec = cfg.MODEL.get(section)
        if sec is not None and bool(sec.get("GENERATING_EXCHANGE_DATA", False)):
            gen = True
            db_path = sec.get("DATABASE_EXCHANGE_DATA", db_path)
    if not gen:
        return None
    if db_path is None:
        raise ValueError("GENERATING_EXCHANGE_DATA set but no DATABASE_EXCHANGE_DATA path")
    thresh = float(cfg.MODEL.get("CORRECTOR", {}).get("THRESHOLD_POINT_CLS_PROB", 0.3))
    logger.info(f"exchange database generation on -> {db_path}")
    return make_exchange_writer(ExchangeDatabase(Path(db_path)), bg_prob_thresh=thresh)


def write_metrics(result_dict, eval_dir):
    """``metrics.json``: the numeric entries of ``result_dict`` as floats."""
    metrics = {k: float(v) for k, v in result_dict.items()
               if isinstance(v, (int, float, np.floating, np.integer))}
    with open(Path(eval_dir) / "metrics.json", "w") as f:
        json.dump(metrics, f, indent=1)
    return metrics


def eval_single_ckpt(model, test_set, test_loader, args, cfg, eval_dir, logger, ckpt=None):
    """Load ``ckpt`` (or ``args.ckpt``, or the newest of ``args.ckpt_dir``)
    into ``model``, evaluate, write ``metrics.json``. Returns the result
    dict. A host model (late fusion) has no weights and is evaluated as it
    is."""
    if not getattr(model, "is_host_model", False):
        _load_weights(model, args, cfg, logger, ckpt)
    result_str, result_dict, _ = eval_one_epoch(
        model, test_set, test_loader, cfg.CLASS_NAMES, logger=logger,
        recall_thresh_list=cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST, output_path=eval_dir,
        exchange_writer=exchange_writer_from_cfg(cfg, logger), infer_time=args.infer_time)
    logger.info("\n" + result_str)
    logger.info(f"result_dict: {result_dict}")
    write_metrics(result_dict, eval_dir)
    return result_dict


def _load_weights(model, args, cfg, logger, ckpt=None):
    """Load the checkpoint to evaluate into ``model``; with ``--bn_recal N``,
    then recalibrate its BN statistics over N train batches."""
    device = next(model.parameters()).device
    ckpt = ckpt or args.ckpt or (latest_checkpoint(args.ckpt_dir) if args.ckpt_dir else None)
    if ckpt is None:
        raise FileNotFoundError("no checkpoint to evaluate: give --ckpt or --ckpt_dir")
    model.load_state_dict(load_params_from_file(ckpt), strict=True)
    logger.info(f"loaded checkpoint {ckpt}")
    if args.bn_recal:
        _, train_loader, _ = build_dataloader(
            dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
            batch_size=args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU,
            workers=args.workers, logger=logger, training=True, seed=0,
            pin_memory=device.type == "cuda")
        recalibrate_batch_stats(model, train_loader, lambda b: _to_device_batch(b, device),
                                max_batches=args.bn_recal, logger=logger)


def get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, start_epoch):
    """(epoch id, path) of the oldest checkpoint of ``ckpt_dir`` from
    ``start_epoch`` on that ``ckpt_record_file`` does not list, else
    (-1, None)."""
    evaluated = set()
    if Path(ckpt_record_file).exists():
        evaluated = {line.strip() for line in open(ckpt_record_file) if line.strip()}
    cands = sorted(Path(ckpt_dir).glob("checkpoint_epoch_*"),
                   key=lambda p: int(re.findall(r"\d+", p.name)[-1]))
    for p in cands:
        epoch_id = re.findall(r"\d+", p.name)[-1]
        if epoch_id not in evaluated and int(epoch_id) >= start_epoch:
            return epoch_id, p
    return -1, None


def repeat_eval_ckpt(model, test_set, test_loader, args, cfg, eval_output_dir, logger, ckpt_dir):
    """Evaluate each checkpoint of ``ckpt_dir`` not yet listed in
    ``eval_list_val.txt``, in epoch order, into ``epoch_{n}/``; wait up to
    ``args.max_waiting_mins`` for new ones (not at all when it is 0)."""
    eval_output_dir = Path(eval_output_dir)
    eval_output_dir.mkdir(parents=True, exist_ok=True)
    ckpt_record_file = eval_output_dir / "eval_list_val.txt"
    ckpt_record_file.touch()
    total_wait, first_eval = 0, True
    while True:
        epoch_id, ckpt = get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, args.start_epoch)
        if epoch_id == -1:
            if args.max_waiting_mins <= 0 or (total_wait > args.max_waiting_mins * 60
                                              and not first_eval):
                break
            logger.info(f"waiting 30 s for new checkpoints in {ckpt_dir} "
                        f"({total_wait / 60:.1f}/{args.max_waiting_mins} min)")
            time.sleep(30)
            total_wait += 30
            continue
        total_wait, first_eval = 0, False
        result_dir = eval_output_dir / f"epoch_{epoch_id}"
        result_dir.mkdir(parents=True, exist_ok=True)
        eval_single_ckpt(model, test_set, test_loader, args, cfg, result_dir, logger, ckpt=ckpt)
        with open(ckpt_record_file, "a") as f:
            print(epoch_id, file=f)
        logger.info(f"epoch {epoch_id} has been evaluated")


def main(argv=None):
    """Evaluate; returns the result dict (of the last checkpoint evaluated
    under ``--eval_all``: None)."""
    args = parse_args(argv)
    cfg, output_dir = load_cfg(args)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    eval_dir = output_dir / "eval"
    if args.eval_tag and args.eval_tag != "default":
        eval_dir = eval_dir / args.eval_tag
    eval_dir.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    logger = create_logger(eval_dir / f"log_eval_{stamp}.txt")
    device = torch.device(args.device)
    apply_tf32(args.tf32)
    if device.type == "cuda":
        logger.info(f"device: {torch.cuda.get_device_name(device)}, torch {torch.__version__}, "
                    f"TF32 in cuDNN {torch.backends.cudnn.allow_tf32}")
    model = build_model(cfg, device)
    test_set, test_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=batch_size,
        workers=args.workers, logger=logger, training=False, pin_memory=device.type == "cuda")
    if args.eval_all:
        if not args.ckpt_dir:
            raise SystemExit("--eval_all requires --ckpt_dir")
        repeat_eval_ckpt(model, test_set, test_loader, args, cfg, eval_dir / "eval_all", logger,
                         args.ckpt_dir)
        return None
    return eval_single_ckpt(model, test_set, test_loader, args, cfg, eval_dir, logger)


if __name__ == "__main__":
    main()
