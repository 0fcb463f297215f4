"""Process groups and the data-parallel layout.

Counterpart of ``pcp_tpu/parallel/mesh.py`` (``make_mesh``,
``shard_batch``, ``replicate_state``) on ``torch.distributed``. The JAX
package shards each batch's leading axis over a device mesh inside one
program; here each rank is a process holding one share of the global batch
(``shard_batch``, or ``datasets/loader.py``'s rank split) and a replica of
the model and optimizer state (``replicate_state``). The backend is named
explicitly: NCCL between cards, gloo on the CPU (gloo also takes CUDA
tensors, so several ranks may share one card). Ranks meet at
``init_method``: ``env://`` under ``torchrun``, or a ``file://`` path.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from .collective import all_gather_objects, get_dist_info


@contextlib.contextmanager
def process_group(rank, world_size, init_method, backend, device=None):
    """The default process group, joined as ``rank`` of ``world_size`` for
    the ``with`` block and torn down after it, whatever happens inside. A
    CUDA ``device`` becomes the rank's current device first (NCCL takes a
    card a rank)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_batch(batch, rank=None, world_size=None):
    """The rank's rows of a global batch dict: each tensor, array or list
    with the batch's leading axis cut to rows [rank * b, (rank + 1) * b), b
    being the global batch over the world size; other entries as they are.
    The default rank and world size are the process group's."""
    if rank is None:
        rank, world_size = get_dist_info()
    n = len(batch["points"])
    if n % world_size:
        raise ValueError(f"a global batch of {n} does not split over {world_size} ranks")
    b = n // world_size
    out = {}
    for key, value in batch.items():
        if isinstance(value, (torch.Tensor, np.ndarray, list)) and len(value) == n:
            out[key] = value[rank * b:(rank + 1) * b]
        else:
            out[key] = value
    return out


@torch.no_grad()
def replicate_state(state):
    """Broadcast rank 0's model parameters and buffers, optimizer moments
    and step counts to every rank, so that the replicas start equal (the
    JAX package's replicated sharding). The ranks must hold optimizer
    state for the same parameters. Returns ``state``."""
    _, world = get_dist_info()
    if world == 1:
        return state
    model, optimizer = state.model, state.optimizer
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    layout = [(i, sorted(k for k, v in optimizer.state[p].items() if torch.is_tensor(v)))
              for i, p in enumerate(params) if optimizer.state.get(p)]
    if any(other != layout for other in all_gather_objects(layout)):
        raise RuntimeError("the ranks hold optimizer state for different parameters")
    for i, keys in layout:
        for k in keys:
            dist.broadcast(optimizer.state[params[i]][k], src=0)
    counts = all_gather_objects([group["count"] for group in optimizer.param_groups])[0]
    for group, count in zip(optimizer.param_groups, counts):
        group["count"] = count
    return state
