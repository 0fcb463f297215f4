"""The spawned ranks of tests/test_torch_parallel.py and
tests/test_torch_parallel_senders.py.

Each spawned rank imports the module of its function afresh, so these live
in a module that imports no JAX (tests/torch_port_helpers.py takes seconds
to import): the test passes the configs and the batch in. The one-process
references of the tests call the same functions outside a process group.
The tests start the ranks with :func:`spawn_ranks`, which fails after
``DEADLINE`` seconds where ``torch.multiprocessing.spawn(join=True)`` would
wait for ever; each rank's process group times out after ``RANK_TIMEOUT``
seconds, so that a rank whose peer died raises.
"""
import copy
import os
import time
from pathlib import Path

import torch

from pcp_tpu_torch.config import CfgDict
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.parallel import (all_reduce_sum, average_reduce_value, merge_results_dist,
                                    process_group, reduce_dict, replicate_state, shard_batch)
from pcp_tpu_torch.models.bev_layers.hunter_jr import _masked_mean
from pcp_tpu_torch.models.bev_layers.hunter_toolbox import hard_mining_regression_loss
from pcp_tpu_torch.models.bev_layers.v2x_fusion_disco import V2XMidFusionDisco
from pcp_tpu_torch.models.loss_fnc.lovasz import ce_lovasz_loss, lovasz_softmax
from pcp_tpu_torch.train.bn_recal import recalibrate_batch_stats
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.train.train_state import create_train_state, init_weights, make_train_step

WORLD = 2
DEADLINE = 600  # seconds the ranks of one spawn may take together
RANK_TIMEOUT = 300  # seconds a collective waits for the other rank


def spawn_ranks(fn, args, nprocs=WORLD, deadline=DEADLINE):
    """``torch.multiprocessing.spawn(fn, args, nprocs)``, joined; the ranks
    still running after ``deadline`` seconds are terminated and the caller
    gets an AssertionError. A rank that fails raises as with ``join=True``."""
    ctx = torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs, join=False)
    end = time.monotonic() + deadline
    while not ctx.join(timeout=max(0.1, min(5.0, end - time.monotonic()))):
        if time.monotonic() >= end:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
            raise AssertionError(f"{fn.__name__}: ranks still running after {deadline} s")


def build(cfg, info):
    return build_network(CfgDict(copy.deepcopy(cfg)), num_class=1,
                         dataset_info=DatasetInfo(**info), device="cpu")


def model_step(cfg, info, optim, seed, batch, dtype=torch.float32):
    """One step of the model of ``cfg`` from ``seed`` on ``batch`` (a dict
    of tensors; this rank's share under a process group) in ``dtype``: the
    global loss and tb, the gradients summed over the ranks, the state dict
    after the step and the step's learning rate."""
    model = build(cfg, info).to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    optimizer, _ = build_optimizer(CfgDict(optim), model, total_iters_each_epoch=10,
                                   total_epochs=1)
    state = replicate_state(create_train_state(model, optimizer, seed))
    loss, tb = make_train_step(model, optimizer)(batch)
    return {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "lr": optimizer.lr_fn(0)}


def one_step(cfg, info, optim, seed, batch, dtype=torch.float32):
    """:func:`model_step` as (loss, tb, the state dict after it, the step's
    learning rate)."""
    out = model_step(cfg, info, optim, seed, batch, dtype)
    return out["loss"], out["tb"], out["state"], out["lr"]


def step_rank(rank, tmp, batch, cfg, car_cfg, car_batch, info, car_info, optim, seed):
    """One rank: its share of the step in float32 and float64, then the
    collectives and a sender's step; written to ``{tmp}/rank{rank}.pt``."""
    torch.set_num_threads(1)
    with process_group(rank, WORLD, f"file://{tmp}/rendezvous", "gloo", timeout=RANK_TIMEOUT):
        share = shard_batch(batch, rank, WORLD)
        loss, tb, sd, _ = one_step(cfg, info, optim, seed, share)
        f64 = one_step(cfg, info, optim, seed, share, torch.float64)
        parts = [[f"b{k}r{rank}i{i}" for i in range(2)] for k in range(3)]
        merged = merge_results_dist([x for p in parts for x in p], total_size=10, chunk=2)
        summed = all_reduce_sum(torch.tensor([rank + 1.0], requires_grad=True))
        summed.backward()
        refused = None
        try:
            car_loss = model_step(car_cfg, car_info, optim, seed,
                                  shard_batch(car_batch, rank, WORLD))["loss"]
        except NotImplementedError as e:
            refused, car_loss = str(e), None
        torch.save({"loss": loss, "tb": tb, "state": sd, "f64": f64, "merged": merged,
                    "reduced": reduce_dict({"a": rank, "b": 2.0 * rank}),
                    "summed": reduce_dict({"a": rank}, average=False),
                    "average": average_reduce_value(10.0 * rank),
                    "all_reduce_sum": float(summed.detach()), "refused": refused,
                    "car_loss": car_loss},
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
        r, w, f"file://{tmp}/rendezvous", backend, device, timeout=RANK_TIMEOUT)
    torch.save(train_cli.main(["--launcher", "pytorch"] + argv), Path(tmp) / f"cli{rank}.pt")


# ------------------------------------------ tests/test_torch_parallel_senders.py

def _distill(inputs, cfg, info, seed):
    """DiscoNet's mid fusion alone in training (no agent): its distillation
    loss from the fused BEV and the early teacher's."""
    fusion = V2XMidFusionDisco(CfgDict(cfg), DatasetInfo(**info), inputs["bev"].shape[1])
    init_weights(fusion, seed)
    fusion.to(inputs["bev"].dtype).train()
    out = fusion({"spatial_features_2d": inputs["bev"], "bev_img_early": inputs["early"]})
    return out["distill_loss"]


PRIMITIVES = {
    "lovasz": lambda x, **_: lovasz_softmax(torch.softmax(x["logits"], -1), x["labels"], x["valid"]),
    "ce_lovasz": lambda x, **_: ce_lovasz_loss(x["logits"], x["labels"], x["valid"], 3),
    "hard_mining": lambda x, **_: hard_mining_regression_loss(x["loss"], x["positive"], x["valid"]),
    "hard_mining_no_positive": lambda x, **_: hard_mining_regression_loss(
        x["loss"], torch.zeros_like(x["positive"]), x["valid"]),
    "masked_mean": lambda x, **_: _masked_mean(x["err"], x["mask"]),
    "distill": _distill,
}


def run_primitive(name, inputs, **kwargs):
    """``PRIMITIVES[name]`` on ``inputs`` (this rank's rows under a process
    group): the global value (the ranks' shares summed) and the gradient of
    the global value with respect to each floating input's rows here."""
    inputs = {k: v.clone().requires_grad_() if v.is_floating_point() else v
              for k, v in inputs.items()}
    share = PRIMITIVES[name](inputs, **kwargs)
    share.backward()
    return {"value": float(all_reduce_sum(share.detach())),
            "grads": {k: v.grad for k, v in inputs.items() if v.is_floating_point()}}


def recalibrated(cfg, info, seed, batches, dtype):
    """The running statistics of the model of ``cfg`` from ``seed`` after
    ``recalibrate_batch_stats`` over ``batches`` (this rank's shares)."""
    model = build(cfg, info).to(dtype)
    init_weights(model, seed)
    recalibrate_batch_stats(model, [{k: v.to(dtype) if v.is_floating_point() else v
                                     for k, v in b.items()} for b in batches], lambda b: b)
    return {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}


def senders_rank(rank, tmp, cases, optim, seed):
    """One rank of tests/test_torch_parallel_senders.py: every primitive,
    the car's and DiscoNet's step and BN recalibration in float64, and the
    small ego's BF16 step, each on this rank's rows;
    written to ``{tmp}/senders{rank}.pt``."""
    torch.set_num_threads(1)
    with process_group(rank, WORLD, f"file://{tmp}/rendezvous", "gloo", timeout=RANK_TIMEOUT):
        out = {"primitives": {name: run_primitive(name, {k: v.chunk(WORLD)[rank] for k, v in x.items()},
                                                  **kw)
                              for name, (x, kw) in cases["primitives"].items()}}
        for name, (cfg, info, batch, dtype) in cases["steps"].items():
            out[name] = model_step(cfg, info, optim, seed, shard_batch(batch, rank, WORLD), dtype)
        out["recal"] = {name: recalibrated(cfg, info, seed,
                                           [shard_batch(b, rank, WORLD) for b in batches],
                                           torch.float64)
                        for name, (cfg, info, batches) in cases["recal"].items()}
        torch.save(out, Path(tmp) / f"senders{rank}.pt")
