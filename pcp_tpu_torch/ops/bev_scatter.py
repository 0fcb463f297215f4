"""Sorted pillar features -> dense BEV grid (segment max), five ways.

Counterpart of ``pcp_tpu/ops/pallas/bev_scatter.py``. Each public function
computes the same grid through its own hand-written CUDA kernel under
``csrc/``, the port of one Pallas kernel:

===================================  ======================  ====================
public function                      kernel (``csrc/*.cu``)  Pallas kernel
===================================  ======================  ====================
``bev_scatter_max_sorted``           ``bev_scatter_max``     ``_make_kernel``
``bev_scatter_max_sorted_prereduced``  ``bev_scatter_tails``   ``_make_tails_kernel``
``bev_scatter_max_sorted_fused``     ``bev_scatter_fused``   ``_make_fused_kernel``
``bev_scatter_max_sorted_onehot``    ``bev_scatter_onehot``  ``_make_onehot_kernel``
``bev_scatter_max_runs``             ``bev_scatter_runs``    ``_make_runs_kernel``
===================================  ======================  ====================

On CUDA tensors a function launches its kernel (``<name>_cuda``); on CPU
tensors it takes the plain PyTorch version beside it (``<name>_plain``),
which repeats the kernel's arithmetic. There is no fallback from one to the
other: a CUDA tensor the kernel cannot take raises. ``launches[kernel]``
counts the launches of each kernel; a plain version never adds to it.

Contract (shared with the JAX package):
  * feats (B, N, C) float32, sorted by flat pillar id within each sample,
    every value >= 0 (the features come after a ReLU);
  * pids (B, N) int32 in [0, H*W]; H*W marks a padding row, which is dropped;
  * returns (B, H, W, C) float32, the max per cell, 0 in empty cells. The
    one-hot variant agrees to 2^-23 relative, the others exactly.

The JAX package carries the pillar id in a float32 lane for its fused and
one-hot kernels and so refuses grids of 2^24 cells or more; here ids stay
int32 everywhere, and every variant takes any grid below 2^31 cells.

Every public function is differentiable in ``feats`` through one shared
``torch.autograd.Function`` (:class:`ScatterMax`): the forward is the kernel
(or the plain version on the CPU), the backward is ``_bev_bwd_impl`` of the
JAX package in torch ops. A cell's cotangent is split evenly over the points
that tie for its max, so the weights of a cell sum to 1;
``torch.scatter_reduce`` has its own rule for ties.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build
from .sorted_segments import segment_ids, segment_total_to_points

# Launches of each CUDA kernel since its count was last set to 0.
launches = {"bev_scatter_max": 0, "bev_scatter_tails": 0, "bev_scatter_fused": 0,
            "bev_scatter_onehot": 0, "bev_scatter_runs": 0}

# Shared-memory bytes of one block's tile (tile cells x C channels x 4 B).
_TILE_BYTES = 16384
_MAX_GRID_Y = 65535
# Rows a block stages at a time for its in-kernel segmented max: kChunk of
# csrc/bev_stream.cuh, one length for both streaming kernels (the K of the
# one-hot kernel's matrix instruction). The plain versions sweep chunks of
# the same length; no result depends on it.
FUSED_CHUNK = ONEHOT_CHUNK = 16
# Cells of one block's tile in the one-hot kernel, at every width: the M of
# the warpgroup matrix instruction (kTileCells of csrc/bev_scatter_onehot.cu).
ONEHOT_TILE_CELLS = 64
# The streaming kernels (fused, one-hot): a block walks a span of tiles, and
# the spans are cut so that every SM gets about this many blocks.
_STREAM_BLOCKS_PER_SM = 32
_FUSED_GROUP = 128  # most channels one block of the fused kernel takes
# The one-hot forward rounds by at most 2^-23 relative; its backward takes a
# point for a cell's max within this tolerance.
ONEHOT_RTOL = 1.2e-7


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------- backward

class ScatterMax(torch.autograd.Function):
    """``forward_fn(feats, pids, h, w)`` with the tie-splitting backward.

    ``rtol`` 0 takes a point for its cell's max only when equal exactly;
    the one-hot forward passes its rounding bound."""

    @staticmethod
    def forward(ctx, feats, pids, h, w, forward_fn, rtol):
        out = forward_fn(feats, pids, h, w)
        ctx.save_for_backward(feats, pids, out)
        ctx.rtol = rtol
        return out

    @staticmethod
    def backward(ctx, g):
        feats, pids, out = ctx.saved_tensors
        b, n, c = feats.shape
        hw = out.shape[1] * out.shape[2]
        if hw == 0 or n == 0:
            return torch.zeros_like(feats), None, None, None, None, None
        idx = pids.long().clamp(0, hw - 1)[..., None].expand(b, n, c)
        cell_max = torch.gather(out.reshape(b, hw, c), 1, idx)
        cell_g = torch.gather(g.reshape(b, hw, c), 1, idx)
        real = (pids < hw)[..., None]
        if ctx.rtol:
            is_max = ((feats - cell_max).abs() <= ctx.rtol * cell_max.abs() + 1e-30) & real
        else:
            is_max = (feats == cell_max) & real
        # pids are sorted, so a cell's tie count is a sorted-segment sum
        ties = segment_total_to_points(is_max.to(feats.dtype), pids, "sum")
        grad = torch.where(is_max, cell_g / ties.clamp(min=1.0), 0.0)
        return grad, None, None, None, None, None


def _dispatch(feats, pids, h, w, plain, cuda, rtol=0.0):
    on_cpu = feats.device.type == "cpu" and pids.device.type == "cpu"
    if not on_cpu and not (feats.is_cuda and pids.is_cuda):
        raise ValueError(f"BEV scatter-max takes CPU tensors or tensors on one CUDA device, "
                         f"got {feats.device} and {pids.device}")
    return ScatterMax.apply(feats, pids, h, w, plain if on_cpu else cuda, rtol)


# ------------------------------------------------------------ kernel launch

@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name, feats, pids, h, w, tails=None, plan=None):
    """Check the inputs, allocate the grid and launch kernel ``name`` on the
    current stream. C signature: (feats, pids, [tails,] out, b, n, hw, c,
    tile_cells, stream) -> CUDA error code; for the streaming kernels the
    numbers of ``plan(b, c, hw, sms)`` stand in place of tile_cells."""
    tensors = [feats, pids] + ([] if tails is None else [tails])
    if not all(t.is_cuda and t.device == feats.device for t in tensors):
        raise ValueError(f"{name} kernel needs its tensors on one CUDA device, got "
                         + " and ".join(str(t.device) for t in tensors))
    if feats.dtype != torch.float32 or any(t.dtype != torch.int32 for t in tensors[1:]):
        raise TypeError(f"{name} kernel takes float32 feats and int32 pids, got "
                        + " and ".join(str(t.dtype) for t in tensors))
    if feats.dim() != 3 or any(t.shape != feats.shape[:2] for t in tensors[1:]):
        raise ValueError(f"{name} kernel takes feats (B, N, C) and pids (B, N), got "
                         + " and ".join(str(tuple(t.shape)) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    b, n, c = feats.shape
    if b > _MAX_GRID_Y or 4 * c > 48 * 1024 or h * w >= 2**31 or n >= 2**31:
        raise ValueError(f"{name} kernel cannot take B={b}, N={n}, C={c}, {h}x{w}")
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    if plan is None:
        ints = [b, n, h * w, c, max(1, _TILE_BYTES // (4 * c))]
    else:
        sms = _sm_count(feats.device)
        ints = [b, n, h * w, c, *plan(b, c, h * w, sms).values()]
    fn = getattr(cuda_build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), *ints, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return out


# ------------------------------------------------- what the plain versions share

def _place(values, pids, keep, h, w, reduce=None):
    """Rows with ``keep`` go to cell ``pids`` of a zeroed grid, every other
    row to a sentinel row that is dropped: a plain store (one kept row a
    cell) or, with ``reduce="amax"``, a max into the cell."""
    b, n, c = values.shape
    hw = h * w
    out = values.new_zeros((b, hw + 1, c))
    idx = torch.where(keep, pids.long(), hw)[..., None].expand(b, n, c)
    if reduce is None:
        out.scatter_(1, idx, values)
    else:
        out.scatter_reduce_(1, idx, values, reduce=reduce, include_self=True)
    return out[:, :hw].reshape(b, h, w, c)


def _chunk_sweep(feats, pids, hw, chunk):
    """The kernels' in-chunk segmented max: N is cut into chunks of ``chunk``
    rows (padded with padding rows), and log2(chunk) shift steps leave in
    every row the max over the rows of its pid at or before it in the chunk.
    Returns the swept values, the padded pids and the tail flags: a row is a
    tail if the next row has another pid or if it is its chunk's last."""
    b, n, c = feats.shape
    pad = -n % chunk
    feats, pids = F.pad(feats, (0, 0, 0, pad)), F.pad(pids, (0, pad), value=hw)
    k = (n + pad) // chunk
    v, p = feats.reshape(b, k, chunk, c), pids.reshape(b, k, chunk)
    d = 1
    while d < chunk:
        same = torch.zeros_like(p, dtype=torch.bool)
        same[..., d:] = p[..., d:] == p[..., :-d]
        v = torch.where(same[..., None], torch.maximum(v, torch.roll(v, d, 2)), v)
        d *= 2
    tail = torch.ones_like(p, dtype=torch.bool)
    tail[..., :-1] = p[..., :-1] != p[..., 1:]
    return v.reshape(b, n + pad, c), pids, tail.reshape(b, n + pad)


# --- per-point accumulate

def bev_scatter_max_sorted(feats, pids, h, w):
    """Dense (B, h, w, C) max-pool of pillar-sorted point features."""
    return _dispatch(feats, pids, h, w, bev_scatter_max_sorted_plain, bev_scatter_max_sorted_cuda)


def bev_scatter_max_sorted_plain(feats, pids, h, w):
    """Plain PyTorch version: ``scatter_reduce_(amax)`` of every row into a
    zeroed grid with one sentinel row for the padding pid."""
    return _place(feats, pids, torch.ones_like(pids, dtype=torch.bool), h, w, "amax")


def bev_scatter_max_sorted_cuda(feats, pids, h, w):
    """Launch ``bev_scatter_max`` (per-point max into a shared-memory tile);
    raise on any input it does not take."""
    return _launch("bev_scatter_max", feats, pids, h, w)


# --- pre-reduced, one store a tail

def prereduce(feats, pids):
    """The pre-reduction in front of the tails kernel (torch ops, as it is
    XLA in the JAX package): every row receives its segment's max, and
    ``tails`` (int32) flags each segment's last row."""
    red = segment_total_to_points(feats, pids, "amax")
    tails = pids != F.pad(pids[:, 1:], (0, 1), value=-1)
    return red, tails.to(torch.int32)


def bev_scatter_max_sorted_prereduced(feats, pids, h, w):
    """Segmented max first, then one store per occupied pillar. Equal to
    :func:`bev_scatter_max_sorted`."""
    return _dispatch(feats, pids, h, w, bev_scatter_max_sorted_prereduced_plain,
                     bev_scatter_max_sorted_prereduced_cuda)


def bev_scatter_max_sorted_prereduced_plain(feats, pids, h, w):
    red, tails = prereduce(feats, pids)
    return bev_scatter_max_tails_plain(red, pids, tails, h, w)


def bev_scatter_max_sorted_prereduced_cuda(feats, pids, h, w):
    red, tails = prereduce(feats, pids)
    return bev_scatter_max_tails_cuda(red.contiguous(), pids, tails.contiguous(), h, w)


def bev_scatter_max_tails_plain(red, pids, tails, h, w):
    """Plain version of the tails kernel: a store of the flagged rows."""
    return _place(red, pids, tails != 0, h, w)


def bev_scatter_max_tails_cuda(red, pids, tails, h, w):
    """Launch ``bev_scatter_tails`` on pre-reduced rows and their flags."""
    return _launch("bev_scatter_tails", red, pids, h, w, tails=tails)


# --- segmented max in the kernel

def bev_scatter_max_sorted_fused(feats, pids, h, w):
    """The segmented max runs inside the kernel, chunk by chunk. Equal to
    :func:`bev_scatter_max_sorted`."""
    return _dispatch(feats, pids, h, w, bev_scatter_max_sorted_fused_plain,
                     bev_scatter_max_sorted_fused_cuda)


def bev_scatter_max_sorted_fused_plain(feats, pids, h, w, chunk=FUSED_CHUNK):
    """Plain version: the in-chunk sweep, then a max of the tail rows (one
    partial max per chunk a segment touches) into the grid."""
    v, p, tail = _chunk_sweep(feats, pids, h * w, chunk)
    return _place(v, p, tail, h, w, "amax")


def bev_scatter_max_sorted_fused_cuda(feats, pids, h, w):
    """Launch ``bev_scatter_fused``."""
    return _launch("bev_scatter_fused", feats, pids, h, w, plan=fused_plan)


def span_tiles(b, tiles, groups, sms):
    """Tiles a block of a streaming kernel walks: a sample's ``tiles`` are cut
    into spans so that the launch has about ``_STREAM_BLOCKS_PER_SM`` blocks
    for each of the card's ``sms`` SMs, at least one tile and at most a
    sample's tiles a block."""
    return min(max(tiles, 1), max(1, -(-b * tiles * groups // (_STREAM_BLOCKS_PER_SM * sms))))


def fused_plan(b, c, hw, sms):
    """Launch numbers of the fused kernel, in its C signature's order: a
    block takes a group of at most 128 channels (one a thread) and tiles of
    ``_TILE_BYTES`` at that width."""
    group = max(1, min(c, _FUSED_GROUP))
    tile_cells = max(1, _TILE_BYTES // (4 * group))
    spans = span_tiles(b, -(-hw // tile_cells), -(-c // group), sms)
    return {"tile_cells": tile_cells, "span_tiles": spans, "group": group}


# --- one-hot product, tensor cores

def bev_scatter_max_sorted_onehot(feats, pids, h, w):
    """Placement as ``onehot(cell)^T @ rows`` with the values split into three
    bfloat16 parts. Agrees with :func:`bev_scatter_max_sorted` to 2^-23
    relative; the backward allows for that rounding."""
    return _dispatch(feats, pids, h, w, bev_scatter_max_sorted_onehot_plain,
                     bev_scatter_max_sorted_onehot_cuda, rtol=ONEHOT_RTOL)


def bev_scatter_max_sorted_onehot_plain(feats, pids, h, w, chunk=ONEHOT_CHUNK):
    """Plain version: the in-chunk sweep, the tail rows split into
    hi/mid/lo bfloat16 parts and summed again in float32 as (hi + mid) + lo
    (what the product with a one-hot matrix returns), then a max of those
    rows into the grid."""
    v, p, tail = _chunk_sweep(feats, pids, h * w, chunk)
    vals = torch.where(tail[..., None], v, 0.0)
    hi = vals.to(torch.bfloat16)
    r1 = vals - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return _place((hi.float() + mid.float()) + lo.float(), p, tail, h, w, "amax")


def bev_scatter_max_sorted_onehot_cuda(feats, pids, h, w):
    """Launch ``bev_scatter_onehot`` (wgmma m64nNk16 bf16, f32 sums in
    registers)."""
    return _launch("bev_scatter_onehot", feats, pids, h, w, plan=onehot_plan)


def onehot_group(c):
    """Channels one block of the one-hot kernel takes, the N of its matrix
    instruction: 32 for grids of at most 32 channels, else 64 (wider grids
    go over more blocks, narrower ones mask the unused columns)."""
    return 32 if c <= 32 else 64


def onehot_plan(b, c, hw, sms):
    """Launch numbers of the one-hot kernel, in its C signature's order."""
    group = onehot_group(c)
    spans = span_tiles(b, -(-hw // ONEHOT_TILE_CELLS), -(-c // group), sms)
    return {"span_tiles": spans, "group": group}


def stream_kernel_resources(name, c):
    """What kernel ``name`` (``bev_scatter_fused`` or ``bev_scatter_onehot``)
    uses as built, at ``c`` channels: registers a thread, static and dynamic
    shared memory, local (spill) bytes a thread and the blocks an SM holds,
    from the CUDA runtime's function attributes and occupancy calculator."""
    plan = {"bev_scatter_fused": fused_plan, "bev_scatter_onehot": onehot_plan}[name](1, c, 1, 1)
    fn = getattr(cuda_build.load(name), f"{name}_resources")
    del plan["span_tiles"]  # what is left sizes a block: (tile_cells,) group
    fn.argtypes = [ctypes.c_int] * len(plan) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    res = (ctypes.c_int * 5)()
    err = fn(*plan.values(), res)
    if err:
        raise RuntimeError(f"{name}_resources failed with CUDA error {err}")
    return dict(zip(("registers", "static_smem", "local_bytes", "dynamic_smem", "blocks_per_sm"),
                    res), **plan)


# --- one store per run of a pid

def bev_scatter_max_runs(feats, pids, h, w):
    """Counterpart of ``_bev_scatter_max_runs_impl``: each run's max is kept
    in a register and stored once. Equal to :func:`bev_scatter_max_sorted`."""
    return _dispatch(feats, pids, h, w, bev_scatter_max_runs_plain, bev_scatter_max_runs_cuda)


def bev_scatter_max_runs_plain(feats, pids, h, w):
    """Plain version: the max of each run into one slot per run, then one
    store per run into the grid (padding runs go to a sentinel row)."""
    b, n, c = feats.shape
    hw = h * w
    seg = segment_ids(pids).reshape(-1)
    run_max = feats.new_zeros((b * n, c)).scatter_reduce_(
        0, seg[:, None].expand(-1, c), feats.reshape(b * n, c), reduce="amax", include_self=True)
    cell = pids.long() + torch.arange(b, device=pids.device)[:, None] * (hw + 1)
    run_cell = torch.full((b * n,), hw, dtype=torch.long, device=pids.device)
    run_cell.scatter_(0, seg, cell.reshape(-1))  # every row of a run writes the same cell
    out = feats.new_zeros((b * (hw + 1), c))
    out.scatter_(0, run_cell[:, None].expand(-1, c), run_max)
    return out.reshape(b, hw + 1, c)[:, :hw].reshape(b, h, w, c)


def bev_scatter_max_runs_cuda(feats, pids, h, w):
    """Launch ``bev_scatter_runs``."""
    return _launch("bev_scatter_runs", feats, pids, h, w)
