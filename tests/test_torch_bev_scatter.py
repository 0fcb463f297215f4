"""The port's BEV scatter-max functions against the JAX package's Pallas kernels.

On the CPU the port takes each function's plain version; the JAX side runs
the matching Pallas kernel in interpret mode. A max does no rounding, so the
default, pre-reduced, fused and runs variants must be equal exactly; the
one-hot variant is held to rtol 1.2e-7. The backward is held against
``jax.grad``. The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops.pallas import bev_scatter as jax_bev
from pcp_tpu.ops.pallas.bev_scatter import bev_scatter_max_sorted as jax_scatter
from pcp_tpu_torch.ops import bev_scatter


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

B, N, C, H, W = 2, 3000, 16, 32, 32  # N is not a multiple of the TPU kernel's chunk

# variant -> (port function, its kernel's name, JAX function taking interpret=True last)
VARIANTS = {
    "prereduced": (bev_scatter.bev_scatter_max_sorted_prereduced, "bev_scatter_tails",
                   jax_bev.bev_scatter_max_sorted_prereduced),
    "fused": (bev_scatter.bev_scatter_max_sorted_fused, "bev_scatter_fused",
              jax_bev.bev_scatter_max_sorted_fused),
    "onehot": (bev_scatter.bev_scatter_max_sorted_onehot, "bev_scatter_onehot",
               jax_bev.bev_scatter_max_sorted_onehot),
    "runs": (bev_scatter.bev_scatter_max_runs, "bev_scatter_runs",
             jax_bev._bev_scatter_max_runs_impl),
}
CASES = ["random", "padded_tail", "all_padding", "one_pillar", "edges"]


def _case(name, rng, shape=(B, N, C, H, W)):
    b, n, c, h, w = shape
    feats = np.maximum(rng.standard_normal((b, n, c)).astype(np.float32), 0.0)
    if name == "random":
        pids = rng.integers(0, h * w + 1, size=(b, n))  # includes the H*W sentinel
    elif name == "padded_tail":
        pids = rng.integers(0, h * w, size=(b, n))
        pids[:, -777:] = h * w
    elif name == "all_padding":
        pids = np.full((b, n), h * w)
    elif name == "one_pillar":
        pids = np.full((b, n), 517)
        feats[:, ::5, ::2] = -0.0  # loses to the cell's +0.0; the same value
    elif name == "edges":
        pids = rng.choice([0, w - 1, h * w - w, h * w - 1, h * w], size=(b, n))
    elif name == "long_runs":
        # runs of 48 rows that cross the TPU kernels' chunks, singletons, padding
        pids = np.concatenate([np.repeat(rng.integers(0, h * w, n // 64), 48),
                               rng.integers(0, h * w, n)])[:n][None].repeat(b, 0)
        pids[:, -37:] = h * w
    pids = np.sort(pids, axis=1).astype(np.int32)
    return feats, pids


def _assert_matches(variant, got, want):
    if variant == "onehot":
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_kernel(name):
    feats, pids = _case(name, np.random.default_rng(5))
    want = np.asarray(jax_scatter(jnp.asarray(feats), jnp.asarray(pids), H, W, True))
    before = dict(bev_scatter.launches)
    got = bev_scatter.bev_scatter_max_sorted(torch.from_numpy(feats), torch.from_numpy(pids), H, W)
    assert bev_scatter.launches == before, "a CPU tensor must not reach the CUDA kernel"
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "all_padding":
        assert not got.any()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_plain_matches_pallas_kernel(variant, name):
    """Each variant's plain version against its own Pallas kernel, and
    against the default function. The largest one-hot error seen over these
    cases is 0.0: the three bfloat16 parts hold every mantissa bit."""
    fn, kernel, jax_fn = VARIANTS[variant]
    feats, pids = _case(name, np.random.default_rng(5))
    want = np.asarray(jax_fn(jnp.asarray(feats), jnp.asarray(pids), H, W, True))
    before = dict(bev_scatter.launches)
    tf, tp = torch.from_numpy(feats), torch.from_numpy(pids)
    got = fn(tf, tp, H, W)
    assert bev_scatter.launches == before, "a CPU tensor must not reach the CUDA kernel"
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    _assert_matches(variant, got.numpy(), want)
    _assert_matches(variant, got.numpy(), bev_scatter.bev_scatter_max_sorted(tf, tp, H, W).numpy())
    if name == "all_padding":
        assert not got.any()


# segments crossing the TPU kernel's chunk: 1024 rows, 256 for the one-hot kernel
CROSSING = {"prereduced": (2, 2 * 1024 + 500, 8, 16, 16), "fused": (2, 2 * 1024 + 500, 8, 16, 16),
            "runs": (2, 2 * 1024 + 500, 8, 16, 16), "onehot": (1, 2 * 256 + 100, 8, 8, 16)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_with_runs_crossing_chunks(variant):
    fn, _, jax_fn = VARIANTS[variant]
    shape = CROSSING[variant]
    h, w = shape[3:]
    feats, pids = _case("long_runs", np.random.default_rng(1), shape)
    want = np.asarray(jax_fn(jnp.asarray(feats), jnp.asarray(pids), h, w, True))
    _assert_matches(variant, fn(torch.from_numpy(feats), torch.from_numpy(pids), h, w).numpy(), want)


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 16, 64, 4096])
@pytest.mark.parametrize("variant", ["fused", "onehot"])
def test_result_does_not_depend_on_the_chunk(variant, chunk):
    plain = {"fused": bev_scatter.bev_scatter_max_sorted_fused_plain,
             "onehot": bev_scatter.bev_scatter_max_sorted_onehot_plain}[variant]
    feats, pids = _case("long_runs", np.random.default_rng(2), (2, 700, 8, 8, 8))
    tf, tp = torch.from_numpy(feats), torch.from_numpy(pids)
    want = bev_scatter.bev_scatter_max_sorted_plain(tf, tp, 8, 8)
    _assert_matches(variant, plain(tf, tp, 8, 8, chunk=chunk).numpy(), want.numpy())


# ------------------------------------------- launch numbers of the streaming kernels

CSRC = Path(bev_scatter.__file__).resolve().parent / "csrc"


def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


def test_plain_chunk_lengths_are_the_kernels():
    """The plain versions sweep chunks of the length the kernels stage, and
    the one-hot tile is the M of its matrix instruction."""
    assert bev_scatter.FUSED_CHUNK == bev_scatter.ONEHOT_CHUNK == _constant("bev_stream.cuh", "kChunk")
    assert bev_scatter.ONEHOT_TILE_CELLS == _constant("bev_scatter_onehot.cu", "kTileCells")


@pytest.mark.parametrize("b,tiles,groups,sms", [(8, 4096, 1, 132), (1, 1, 1, 132), (3, 5, 1, 132),
                                                (2, 4, 4, 8), (8, 33554432, 1, 132),
                                                (1, 100000, 96, 1)])
def test_span_tiles_cover_every_tile_with_about_the_aimed_blocks(b, tiles, groups, sms):
    span = bev_scatter.span_tiles(b, tiles, groups, sms)
    assert span >= 1
    blocks = -(-tiles // span) * b * groups
    aim = bev_scatter._STREAM_BLOCKS_PER_SM * sms
    assert -(-tiles // span) * span >= tiles
    # where a block has more than one tile and less than a sample, the launch
    # has the aimed number of blocks, or down to half of it (less what
    # rounding a sample's spans up costs)
    if 1 < span < tiles:
        assert aim // 2 - b * groups <= blocks <= aim
    else:
        assert span == 1 or blocks == b * groups


@pytest.mark.parametrize("c", [1, 7, 24, 32, 33, 64, 128, 129, 200, 1700])
def test_stream_plans(c):
    """The launch numbers come in the order of the C signatures, every
    channel has a block, and a tile fits the block's resources."""
    hw, sms = 512 * 512, 132
    fused = bev_scatter.fused_plan(8, c, hw, sms)
    assert list(fused) == ["tile_cells", "span_tiles", "group"]
    assert 1 <= fused["group"] <= 128 and fused["group"] == min(c, 128)
    assert fused["tile_cells"] >= 1
    assert fused["tile_cells"] * fused["group"] * 4 <= max(16384, 4 * fused["group"])
    onehot = bev_scatter.onehot_plan(8, c, hw, sms)
    assert list(onehot) == ["span_tiles", "group"]
    assert onehot["group"] == (32 if c <= 32 else 64)
    for plan, tile_cells in ((fused, fused["tile_cells"]), (onehot, bev_scatter.ONEHOT_TILE_CELLS)):
        tiles = -(-hw // tile_cells)
        groups = -(-c // plan["group"])
        assert plan["span_tiles"] == bev_scatter.span_tiles(8, tiles, groups, sms)
        assert groups * plan["group"] >= c


def _streaming_walk(feats, pids, hw, tile_cells, span, chunk=16):
    """The streaming kernels' control flow for one sample, in numpy: a block
    a span of tiles, one search for its first row, windows of ``chunk`` rows
    from there, a tile's end read from the window's pids, a chunk what a
    window holds of one tile, chunk-local tails folded by max, runs of empty
    tiles written as zeros. Returns the grid, how often each cell was
    written and the number of chunks."""
    n, c = feats.shape
    out = np.full((hw, c), np.nan, np.float32)
    writes = np.zeros(hw, int)
    chunks = 0
    tiles = -(-hw // tile_cells)
    for block in range(-(-tiles // span)):
        tile, tile_end = block * span, min(tiles, (block + 1) * span)
        row0 = int(np.searchsorted(pids, tile * tile_cells, "left"))
        w, j0, dirty, buf = -1, chunk, False, np.zeros((tile_cells, c), np.float32)
        while tile < tile_end:
            if j0 == chunk:
                w, j0 = w + 1, 0
                r = row0 + w * chunk
                m = max(0, min(chunk, n - r))
                spid = np.full(chunk, hw)
                spid[:m] = pids[r:r + m]
                sval = np.zeros((chunk, c), np.float32)
                sval[:m] = feats[r:r + m]
            cell0, cell_end = tile * tile_cells, min((tile + 1) * tile_cells, hw)
            if not dirty and spid[j0] >= cell_end:
                nxt = min(tile_end, max(tile + 1, spid[j0] // tile_cells))
                upto = min(nxt * tile_cells, hw)
                out[cell0:upto] = 0
                writes[cell0:upto] += 1
                tile = nxt
                continue
            j1 = j0 + int((spid[j0:] < cell_end).sum())
            if j1 > j0:
                chunks += 1
                run = np.zeros(c, np.float32)
                for j in range(j0, j1):
                    run = np.maximum(run, sval[j]) if j > j0 and spid[j] == spid[j - 1] else sval[j]
                    if j == j1 - 1 or spid[j + 1] != spid[j]:
                        buf[spid[j] - cell0] = np.maximum(buf[spid[j] - cell0], run)
                dirty, j0 = True, j1
                if j0 == chunk:
                    continue
            out[cell0:cell_end] = buf[:cell_end - cell0]
            writes[cell0:cell_end] += 1
            buf[:] = 0
            dirty = False
            tile += 1
    return out, writes, chunks


@pytest.mark.parametrize("name", CASES + ["long_runs"])
@pytest.mark.parametrize("tile_cells,span", [(64, 1), (64, 5), (7, 3), (1, 1000)])
def test_streaming_walk_writes_every_cell_once(name, tile_cells, span):
    """The walk the fused and one-hot kernels do over spans, windows and
    tiles gives the default function's grid and writes each cell once, so
    their output may be ``torch.empty``."""
    h, w = 24, 23
    feats, pids = _case(name, np.random.default_rng(11), (2, 700, 3, h, w))
    want = bev_scatter.bev_scatter_max_sorted_plain(torch.from_numpy(feats), torch.from_numpy(pids),
                                                    h, w).numpy().reshape(2, h * w, 3)
    for i in range(2):
        got, writes, _ = _streaming_walk(feats[i], pids[i], h * w, tile_cells, span)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want[i])


@pytest.mark.parametrize("name", CASES + ["long_runs"])
@pytest.mark.parametrize("tile_cells,span", [(64, 1), (64, 5), (7, 3), (1, 1000)])
def test_smoke_script_counts_the_walks_chunks(name, tile_cells, span):
    """chip_smoke.py's operation count for the one-hot kernel's bound has one
    product for every chunk of the walk, a tile that straddles a window's
    border counted twice."""
    import chip_smoke

    h, w, cp = 24, 23, 32
    feats, pids = _case(name, np.random.default_rng(12), (2, 700, 3, h, w))
    chunks = sum(_streaming_walk(feats[i], pids[i], h * w, tile_cells, span)[2] for i in range(2))
    ops = chip_smoke.onehot_product_ops(torch.from_numpy(pids), h * w, tile_cells, 16, span, cp)
    assert ops == chunks * 2 * tile_cells * 16 * 3 * cp
    by_tile = sum(-(-int(k) // 16) for i in range(2)
                  for k in np.bincount(pids[i][pids[i] < h * w] // tile_cells))
    assert chunks >= by_tile


def test_tails_plain_stores_only_flagged_rows():
    """The tails version is a store, not a max: a flag on a wrong row shows."""
    feats = torch.tensor([[[1.0], [5.0], [2.0], [7.0]]])
    pids = torch.tensor([[3, 3, 3, 4]], dtype=torch.int32)
    red, tails = bev_scatter.prereduce(feats, pids)
    assert tails.tolist() == [[0, 0, 1, 1]] and red.reshape(-1).tolist() == [5.0, 5.0, 5.0, 7.0]
    wrong = torch.tensor([[1, 0, 0, 1]], dtype=torch.int32)
    out = bev_scatter.bev_scatter_max_tails_plain(feats, pids, wrong, 1, 5).reshape(-1)
    assert out.tolist() == [0.0, 0.0, 0.0, 1.0, 7.0]


def test_non_cpu_tensor_never_takes_plain_version():
    feats = torch.zeros((1, 4, C), device="meta")
    pids = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        bev_scatter.bev_scatter_max_sorted(feats, pids, H, W)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_non_cpu_tensor_never_takes_plain_version(variant):
    fn, kernel, _ = VARIANTS[variant]
    feats = torch.zeros((1, 4, C), device="meta")
    pids = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fn(feats, pids, H, W)
    with pytest.raises(ValueError, match="CUDA device"):
        getattr(bev_scatter, fn.__name__ + "_cuda")(feats, pids, H, W)
    with pytest.raises(ValueError, match="CUDA device"):  # one tensor on the CPU is not enough
        fn(feats, torch.zeros((1, 4), dtype=torch.int32), H, W)
    assert bev_scatter.launches[kernel] == 0


@pytest.mark.parametrize("shape", [(0, 5, 4, 2, 3), (2, 0, 4, 2, 3), (2, 5, 0, 2, 3),
                                   (2, 5, 4, 0, 3)])
@pytest.mark.parametrize("variant", ["default"] + list(VARIANTS))
def test_empty_sizes(variant, shape):
    fn = bev_scatter.bev_scatter_max_sorted if variant == "default" else VARIANTS[variant][0]
    b, n, c, h, w = shape
    out = fn(torch.ones((b, n, c)), torch.full((b, n), h * w, dtype=torch.int32), h, w)
    assert out.shape == (b, h, w, c) and not out.any()


# ----------------------------------------------------------------- backward

GRAD_SHAPES = {"default": (2, 512, 8, 8, 8), "prereduced": (2, 512, 8, 16, 16),
               "fused": (2, 2 * 1024 + 500, 8, 16, 16), "onehot": (1, 2 * 256 + 100, 8, 8, 16),
               "runs": (2, 512, 8, 8, 8)}


def _port_fn(variant):
    return bev_scatter.bev_scatter_max_sorted if variant == "default" else VARIANTS[variant][0]


def _jax_vjp_fn(variant):
    # the runs kernel has no VJP of its own in the JAX package: it computes
    # the default function, whose gradient is the one to match
    return jax_scatter if variant in ("default", "runs") else VARIANTS[variant][2]


def _grads(variant, feats, pids, h, w, weight=None):
    """Gradient of sum(out**2), or of sum(out * weight), in both packages."""
    jp = jnp.asarray(pids)
    jax_fn = _jax_vjp_fn(variant)

    def jax_loss(f):
        out = jax_fn(f, jp, h, w, True)
        return jnp.sum(out ** 2) if weight is None else jnp.sum(out * jnp.asarray(weight))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(feats)))
    tf = torch.from_numpy(feats).requires_grad_(True)
    out = _port_fn(variant)(tf, torch.from_numpy(pids), h, w)
    loss = (out ** 2).sum() if weight is None else (out * torch.from_numpy(weight)).sum()
    (got,) = torch.autograd.grad(loss, tf)
    return got.numpy(), want


@pytest.mark.parametrize("variant", list(GRAD_SHAPES))
def test_backward_matches_jax_grad(variant):
    shape = GRAD_SHAPES[variant]
    h, w = shape[3:]
    feats, pids = _case("long_runs" if variant in ("fused", "onehot") else "random",
                        np.random.default_rng(7), shape)
    feats = np.abs(np.random.default_rng(8).normal(size=feats.shape)).astype(np.float32)
    got, want = _grads(variant, feats, pids, h, w)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    assert not got[pids == h * w].any(), "padding rows receive no gradient"


@pytest.mark.parametrize("variant", list(GRAD_SHAPES))
def test_backward_splits_exact_ties(variant):
    """Post-ReLU zeros and duplicated rows tie for a cell's max: the cell's
    cotangent is split evenly over them, and a cell's weights sum to 1.
    (torch.scatter_reduce's own gradient counts the zeroed grid's entry as
    one more tie, so it does not match the JAX package on cells whose max is
    0.)"""
    b, n, c, h, w = 2, 400, 4, 4, 4
    rng = np.random.default_rng(9)
    feats, pids = _case("random", rng, (b, n, c, h, w))  # about half the values are 0
    feats[:, 1::2] = feats[:, 0::2]  # every row twice: in one pillar wherever pids agree
    feats[0, pids[0] == 3] = 0.0  # a pillar whose max is 0 in every channel
    weight = rng.standard_normal((b, h, w, c)).astype(np.float32)
    got, want = _grads(variant, feats, pids, h, w, weight)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    rows = pids[0] == 3
    np.testing.assert_allclose(got[0, rows], np.broadcast_to(weight[0, 0, 3] / rows.sum(),
                                                            (rows.sum(), c)), rtol=1e-6)
    # per cell the gradient sums to the cell's cotangent
    cell_sum = np.zeros((b, h * w + 1, c), np.float64)
    for i in range(b):
        np.add.at(cell_sum[i], pids[i], got[i])
    occupied = np.zeros((b, h * w + 1), bool)
    for i in range(b):
        occupied[i, pids[i]] = True
    np.testing.assert_allclose(cell_sum[:, :-1][occupied[:, :-1]],
                               weight.reshape(b, h * w, c)[occupied[:, :-1]], rtol=1e-5, atol=1e-6)
    # torch's own amax gradient differs on the ties at 0
    tf = torch.from_numpy(feats).requires_grad_(True)
    idx = torch.from_numpy(pids).long()[..., None].expand(b, n, c)
    ref = torch.zeros((b, h * w + 1, c)).scatter_reduce(1, idx, tf, "amax", include_self=True)
    (torch_grad,) = torch.autograd.grad((ref[:, :-1].reshape(b, h, w, c)
                                         * torch.from_numpy(weight)).sum(), tf)
    assert not np.allclose(torch_grad.numpy(), want, atol=1e-6)
