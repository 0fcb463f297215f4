"""Collectives over the ranks of a data-parallel run.

Counterpart of ``pcp_tpu/parallel/collective.py`` (``get_dist_info``,
``all_gather_objects``, ``merge_results_dist``, ``average_reduce_value``,
``reduce_dict``), on ``torch.distributed``'s default process group. Each is
a no-op in a single process, as in the JAX package.

The JAX package's train step is jitted over a sharded batch, so XLA computes
it as the single-device step over the global batch: batch statistics and
loss normalisers over every device's rows, and the gradient of that loss.
:func:`all_reduce_sum` (autograd-aware: its backward sums the ranks'
cotangents) and :func:`all_reduce_gradients` are what give the port's step
the same semantics (``models/model_utils/norm.py``,
``models/loss_fnc/centernet_losses.py``, ``train/train_state.py``).
"""
import torch
import torch.distributed as dist


def get_dist_info():
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_gather_objects(obj):
    """Every rank's ``obj`` (any picklable), in rank order; ``[obj]`` in one
    process."""
    _, world = get_dist_info()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def merge_results_dist(part_list, total_size, chunk=1):
    """The ranks' per-sample results merged into the global order, cut to
    ``total_size`` (dropping the loader's padding), on every rank. Each rank
    holds its share of every global batch in order, ``chunk`` results a
    batch (the loader's per-rank batch size): the merge takes batch 0's
    shares rank by rank, then batch 1's. With ``chunk`` 1 this is pcdet's
    interleave (``common_utils.merge_results_dist``)."""
    parts = all_gather_objects(list(part_list))
    merged = []
    for start in range(0, max(len(p) for p in parts), chunk):
        for p in parts:
            merged.extend(p[start:start + chunk])
    return merged[:total_size]


def average_reduce_value(value):
    """The mean of a scalar over the ranks."""
    vals = all_gather_objects(float(value))
    return sum(vals) / len(vals)


def reduce_dict(d, average=True):
    """Each entry's mean (or sum) over the ranks; the keys must agree."""
    keys = sorted(d)
    gathered = all_gather_objects([float(d[k]) for k in keys])
    out = {}
    for i, k in enumerate(keys):
        total = sum(g[i] for g in gathered)
        out[k] = total / len(gathered) if average else total
    return out


def barrier():
    """Wait for every rank; nothing in one process."""
    if get_dist_info()[1] > 1:
        dist.barrier()


def all_reduce_sum(tensor):
    """The sum of ``tensor`` over the ranks, differentiable: the backward
    sums the ranks' gradients of the result, so each rank's input receives
    the gradient of every rank's use of the sum. ``tensor`` itself in one
    process."""
    _, world = get_dist_info()
    if world == 1:
        return tensor
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(tensor)


@torch.no_grad()
def all_reduce_gradients(params):
    """Sum each parameter's gradient over the ranks in place (zeros for a
    parameter that got none, as JAX differentiates every leaf), in one
    collective. Nothing in one process."""
    _, world = get_dist_info()
    params = [p for p in params if p.requires_grad]
    if world == 1 or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
