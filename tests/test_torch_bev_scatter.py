"""The port's BEV scatter-max functions against the JAX package's Pallas kernels.

On the CPU the port takes each function's plain version; the JAX side runs
the matching Pallas kernel in interpret mode. A max does no rounding, so the
default, pre-reduced, fused and runs variants must be equal exactly; the
one-hot variant is held to rtol 1.2e-7. The backward is held against
``jax.grad``. The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops.pallas import bev_scatter as jax_bev
from pcp_tpu.ops.pallas.bev_scatter import bev_scatter_max_sorted as jax_scatter
from pcp_tpu_torch.ops import bev_scatter

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


@pytest.mark.parametrize("chunk", [1, 2, 16, 64, 4096])
@pytest.mark.parametrize("variant", ["fused", "onehot"])
def test_result_does_not_depend_on_the_chunk(variant, chunk):
    plain = {"fused": bev_scatter.bev_scatter_max_sorted_fused_plain,
             "onehot": bev_scatter.bev_scatter_max_sorted_onehot_plain}[variant]
    feats, pids = _case("long_runs", np.random.default_rng(2), (2, 700, 8, 8, 8))
    tf, tp = torch.from_numpy(feats), torch.from_numpy(pids)
    want = bev_scatter.bev_scatter_max_sorted_plain(tf, tp, 8, 8)
    _assert_matches(variant, plain(tf, tp, 8, 8, chunk=chunk).numpy(), want.numpy())


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
