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

**Losses over the global batch.** ``make_train_step`` sums the ranks' loss
shares and ``all_reduce_gradients`` sums their gradients, so each rank's
loss must be its share of the one-process loss over the global batch:

* a loss that is a sum over rows divided by a count (a masked mean, a CE
  normaliser, a mean over pixels) takes this rank's sum over the global
  count (:func:`all_reduce_sum` of the count);
* a loss that is not a sum over rows (a Lovász extension, a top-k of
  negatives) is computed whole on every rank from the global rows, which
  :func:`all_gather` gives in the one-process order, and enters each rank's
  loss at ``1 / world`` (:func:`whole_share`). Every rank's cotangent of a
  gathered row is then ``1 / world`` of the whole loss's, and
  :func:`all_gather`'s backward sums the ``world`` ranks' cotangents into
  the rows' owner: each row gets the whole loss's gradient once.
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


class _AllGatherRows(torch.autograd.Function):
    """The ranks' rows concatenated in rank order; the backward sums every
    rank's cotangent of the result and hands each rank its own rows'."""

    @staticmethod
    def forward(ctx, tensor, sizes):
        rank = dist.get_rank()
        padded = tensor.new_zeros((max(sizes),) + tuple(tensor.shape[1:]))
        padded[:len(tensor)] = tensor
        parts = [torch.empty_like(padded) for _ in sizes]
        dist.all_gather(parts, padded)
        ctx.start, ctx.rows = sum(sizes[:rank]), sizes[rank]
        return torch.cat([p[:n] for p, n in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.start:ctx.start + ctx.rows], None


def all_gather(*tensors):
    """Every rank's rows of each of ``tensors`` (which share their first
    axis) concatenated in rank order, differentiable (see the module's
    rule); one tensor for one, a tuple for several. Rank r holds rows
    ``[r * b, (r + 1) * b)`` of the global batch (``mesh.shard_batch``, the
    loader's rank split), so a flat (B * N, ...) tensor comes back in the
    one-process row order, and a stable sort of it breaks ties as one
    process does. The ranks may hold different numbers of rows; the one
    exchange of the counts waits for the card, once for all ``tensors``.
    The tensors themselves in one process."""
    _, world = get_dist_info()
    if world > 1:
        count = torch.full((1,), len(tensors[0]), device=tensors[0].device, dtype=torch.int64)
        counts = [torch.empty_like(count) for _ in range(world)]
        dist.all_gather(counts, count)
        sizes = torch.cat(counts).tolist()
        # gloo and NCCL gather bytes, not bools
        tensors = tuple(_AllGatherRows.apply(t.to(torch.uint8), sizes).bool()
                        if t.dtype == torch.bool else _AllGatherRows.apply(t.contiguous(), sizes)
                        for t in tensors)
    return tensors[0] if len(tensors) == 1 else tensors


def whole_share(value):
    """This rank's share of a loss that every rank computes whole from
    :func:`all_gather`'s rows: ``value / world`` (divided by a tensor filled
    on the device, as every division of the port is by a tensor); ``value``
    in one process."""
    _, world = get_dist_info()
    if world == 1:
        return value
    return value / torch.full((), float(world), dtype=value.dtype, device=value.device)


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
