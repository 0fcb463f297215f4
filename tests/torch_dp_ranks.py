"""The spawned ranks of tests/test_torch_parallel.py.

Each spawned rank imports the module of its function afresh, so these live
in a module that imports no JAX (tests/torch_port_helpers.py takes seconds
to import): the test passes the configs and the batch in.
"""
import copy
import os
from pathlib import Path

import torch

from pcp_tpu_torch.config import CfgDict
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.parallel import (all_reduce_sum, average_reduce_value, merge_results_dist,
                                    process_group, reduce_dict, replicate_state, shard_batch)
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.train.train_state import create_train_state, make_train_step

WORLD = 2


def build(cfg, info):
    return build_network(CfgDict(copy.deepcopy(cfg)), num_class=1,
                         dataset_info=DatasetInfo(**info), device="cpu")


def one_step(cfg, info, optim, seed, batch, dtype=torch.float32):
    """One step of the model of ``cfg`` from ``seed`` on ``batch`` (numpy
    points, mask, gt boxes, or a dict of tensors) in ``dtype``: (loss, tb,
    the state dict after it, the step's learning rate)."""
    model = build(cfg, info).to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    optimizer, _ = build_optimizer(CfgDict(optim), model, total_iters_each_epoch=10,
                                   total_epochs=1)
    state = replicate_state(create_train_state(model, optimizer, seed))
    loss, tb = make_train_step(model, optimizer)(batch)
    return (float(loss), {k: float(v) for k, v in tb.items()},
            {k: v.clone() for k, v in state.model.state_dict().items()},
            optimizer.lr_fn(0))


def step_rank(rank, tmp, batch, cfg, car_cfg, info, optim, seed):
    """One rank: its share of the step in float32 and float64, then the
    collectives and a sender's step; written to ``{tmp}/rank{rank}.pt``."""
    torch.set_num_threads(1)
    with process_group(rank, WORLD, f"file://{tmp}/rendezvous", "gloo"):
        share = shard_batch(batch, rank, WORLD)
        loss, tb, sd, _ = one_step(cfg, info, optim, seed, share)
        f64 = one_step(cfg, info, optim, seed, share, torch.float64)
        parts = [[f"b{k}r{rank}i{i}" for i in range(2)] for k in range(3)]
        merged = merge_results_dist([x for p in parts for x in p], total_size=10, chunk=2)
        summed = all_reduce_sum(torch.tensor([rank + 1.0], requires_grad=True))
        summed.backward()
        refused = None
        car = build(car_cfg, info)
        car_opt, _ = build_optimizer(CfgDict(optim), car, total_iters_each_epoch=10,
                                     total_epochs=1)
        try:
            make_train_step(car, car_opt)({})
        except NotImplementedError as e:
            refused = str(e)
        torch.save({"loss": loss, "tb": tb, "state": sd, "f64": f64, "merged": merged,
                    "reduced": reduce_dict({"a": rank, "b": 2.0 * rank}),
                    "summed": reduce_dict({"a": rank}, average=False),
                    "average": average_reduce_value(10.0 * rank),
                    "all_reduce_sum": float(summed.detach()), "refused": refused},
                   Path(tmp) / f"rank{rank}.pt")


def cli_rank(rank, tmp, argv):
    """A rank of ``tools/train.py --launcher pytorch`` as torchrun starts it,
    meeting the other at a file store in place of torchrun's TCP one; the
    summary written to ``{tmp}/cli{rank}.pt``."""
    from pcp_tpu_torch.tools import train as train_cli

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    meet = train_cli.process_group
    train_cli.process_group = lambda r, w, _, backend, device: meet(
        r, w, f"file://{tmp}/rendezvous", backend, device)
    torch.save(train_cli.main(["--launcher", "pytorch"] + argv), Path(tmp) / f"cli{rank}.pt")
