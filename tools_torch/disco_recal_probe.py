"""Evaluate a DiscoNet checkpoint after recalibrating its BN statistics the
way the JAX package's ``recalibrate_batch_stats`` does, or the port's way.

    python3 tools_torch/disco_recal_probe.py {jax,port} <the test CLI's arguments> --bn_recal 30

The JAX package recovers each batch's statistics from passes that start
from an all-zeros statistics tree, DiscoNet's frozen BEV makers' statistics
included, which their eval-mode forward reads: during those passes the
makers normalise by zero statistics, each BN multiplying by 1/sqrt(eps), and
every BN that reads their BEVs (the compressor, then the weightor, the
decompressor and the head) sees values that float32 may not square. The
JAX package keeps the old value of every statistic whose rate comes back
non-finite and takes the others, however large. ``jax`` reproduces that in
the port's arithmetic: the makers' statistics are zero while the port's
recalibration runs, and every statistic that comes back non-finite takes
its value from before. ``port`` runs the port's own recalibration, where the
makers read their trained statistics. Either way the rest is
``tools/test.py``'s evaluation; give each style its own ``--eval_tag``. To
start from the training's own running statistics, train with
``--precise_bn 0``.
"""
import sys
from pathlib import Path

import torch
from torch.nn.modules.batchnorm import _BatchNorm

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from pcp_tpu_torch.tools import test as test_cli  # noqa: E402
from pcp_tpu_torch.train.bn_recal import recalibrate_batch_stats  # noqa: E402


def jax_style(model, loader, to_device, max_batches=None, logger=None):
    """The port's recalibration run while the makers' statistics are 0; a
    statistic that comes back non-finite keeps its earlier value."""
    norms = [(name, m) for name, m in model.named_modules() if isinstance(m, _BatchNorm)]
    kept = {name: (m.running_mean.clone(), m.running_var.clone()) for name, m in norms}
    makers = {name for name, _ in norms if name.startswith("bev_maker")}
    with torch.no_grad():
        for name, m in norms:
            if name in makers:
                m.running_mean.zero_()
                m.running_var.zero_()
    try:
        return recalibrate_batch_stats(model, loader, to_device, max_batches, logger)
    finally:
        stale = []
        with torch.no_grad():
            for name, m in norms:
                for key, old in zip(("running_mean", "running_var"), kept[name]):
                    stat = getattr(m, key)
                    bad = ~torch.isfinite(stat)
                    if name in makers:
                        stat.copy_(old)
                    elif bad.any():
                        stat.copy_(torch.where(bad, old, stat))
                        stale.append(f"{name}.{key}")
        if logger is not None:
            logger.info(f"JAX-style recalibration: {len(makers)} maker BNs at zero statistics; "
                        f"{len(stale)} statistics came back non-finite and keep their values: "
                        f"{stale}")


def main(argv):
    style, rest = argv[0], argv[1:]
    if style not in ("jax", "port"):
        raise SystemExit("usage: disco_recal_probe.py {jax,port} <test CLI arguments>")
    test_cli.recalibrate_batch_stats = jax_style if style == "jax" else recalibrate_batch_stats
    return test_cli.main(rest)


if __name__ == "__main__":
    main(sys.argv[1:])
