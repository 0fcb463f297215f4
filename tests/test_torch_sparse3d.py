"""The port's sparse 3D ops and the SECOND VFE against the JAX package.

Inputs are made from a seed with numpy and go through
``pcp_tpu/ops/sparse3d.py`` and ``pcp_tpu_torch/ops/sparse3d.py``, and through
the two ``DynamicMeanVFE``. Tolerances:

* the gather map, ``compact_unique``, the neighbour maps and the strided
  output ids: equal, with budgets both above and below the number of
  unique sites (overflow drops exactly the sites JAX drops);
* submanifold and strided convs: atol 1e-5 / rtol 1e-5 (the port sums the
  K taps inside one GEMM, the JAX package adds K einsums);
* ``DynamicMeanVFE``: voxel ids equal, features atol 1e-6 / rtol 1e-6 (segment
  sums in another order), with padding, out-of-range points and a
  ``MAX_VOXELS`` under the occupied voxels;
* ``sparse_to_dense`` and ``HeightCompression`` (channel ``c * nz + z``): equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.models.map_to_bev.height_compression import HeightCompression as JaxHC
from pcp_tpu.models.vfe.dynamic_mean_vfe import DynamicMeanVFE as JaxMeanVFE
from pcp_tpu.ops import sparse3d as js
from pcp_tpu_torch.models.map_to_bev.height_compression import HeightCompression
from pcp_tpu_torch.models.vfe.dynamic_mean_vfe import DynamicMeanVFE
from pcp_tpu_torch.ops import sparse3d as ts


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def make_sparse(rng, b, v, dims, c, fill=(0.5, 1.0)):
    """(ids (B, V) sorted with a padding tail, feats (B, V, C)) in numpy."""
    limit = int(np.prod(dims))
    ids = np.full((b, v), limit, np.int32)
    feats = np.zeros((b, v, c), np.float32)
    for i in range(b):
        n_act = int(rng.integers(int(v * fill[0]), int(v * fill[1]) + 1))
        ids[i, :n_act] = np.sort(rng.choice(limit, size=n_act, replace=False))
        feats[i, :n_act] = rng.normal(0, 1, (n_act, c))
    return ids, feats


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64 if np.asarray(x).dtype.kind == "i"
                                                  else np.float32))


def test_gather_map_matches_jax():
    rng = np.random.default_rng(0)
    dims = (6, 10, 10)
    limit = int(np.prod(dims))
    ids, _ = make_sparse(rng, 3, 80, dims, 1)
    queries = rng.integers(0, limit + 1, (3, 300)).astype(np.int32)
    queries[:, :40] = ids[:, 10:50]  # hits, the padding tail among them
    want = np.asarray(js.build_gather_map(jnp.asarray(ids), jnp.asarray(queries), limit))
    got = ts.build_gather_map(_t(ids), _t(queries), limit).numpy()
    assert (want >= 0).sum() > 40
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("budget", [16, 64, 400])
def test_compact_unique_matches_jax(budget):
    """Duplicates, padding and, at budgets 16 and 64, more unique ids than
    slots: the first ``budget`` in id order survive."""
    rng = np.random.default_rng(1)
    limit = 500
    ids = rng.integers(0, 150, (2, 300)).astype(np.int32)
    ids[:, ::7] = limit
    want = np.asarray(js.compact_unique(jnp.asarray(ids), budget, limit))
    got = ts.compact_unique(_t(ids), budget, limit).numpy()
    np.testing.assert_array_equal(got, want)


STRIDED = [(3, 2, 1), (3, 2, (0, 1, 1)), ((3, 1, 1), (2, 1, 1), 0)]


def _out_dims(dims, k, s, p):
    k, s, p = (x if isinstance(x, tuple) else (x,) * 3 for x in (k, s, p))
    return tuple((dims[i] + 2 * p[i] - k[i]) // s[i] + 1 for i in range(3))


@pytest.mark.parametrize("kernel,stride,padding", STRIDED)
@pytest.mark.parametrize("budget", [40, 120])
def test_strided_output_ids_match_jax(kernel, stride, padding, budget):
    """At budget 40 the candidate sites overflow it, at 120 they do not."""
    rng = np.random.default_rng(2)
    dims = (9, 12, 12)
    ids, _ = make_sparse(rng, 2, 120, dims, 1, fill=(0.3, 0.6))
    od = _out_dims(dims, kernel, stride, padding)
    args = (dims, od, kernel, stride, padding)
    want = np.asarray(js.strided_output_ids(jnp.asarray(ids), *args, budget=budget))
    got = ts.strided_output_ids(_t(ids), *args, budget=budget).numpy()
    limit_out = int(np.prod(od))
    if budget == 40:
        assert ((want < limit_out).sum(1) == budget).all()
    np.testing.assert_array_equal(got, want)


def test_subm_conv_matches_jax():
    rng = np.random.default_rng(3)
    dims, cin, cout = (5, 10, 10), 4, 6
    ids, feats = make_sparse(rng, 2, 96, dims, cin)
    offs = js.kernel_offsets(3)
    np.testing.assert_array_equal(ts.kernel_offsets(3), offs)
    w = rng.normal(0, 0.3, (27, cin, cout)).astype(np.float32)
    jmap = js.neighbor_map_subm(jnp.asarray(ids), offs, dims)
    tmap = ts.neighbor_map_subm(_t(ids), ts.kernel_offsets(3), dims)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    assert (np.asarray(jmap)[:, 13] >= 0).sum() == (ids < np.prod(dims)).sum()  # the centre tap
    want = np.asarray(js.subm_conv_apply(jnp.asarray(feats), jmap, jnp.asarray(w)))
    got = ts.subm_conv_apply(_t(feats), tmap, _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel,stride,padding", STRIDED)
def test_strided_conv_matches_jax(kernel, stride, padding):
    rng = np.random.default_rng(4)
    dims, cin, cout = (7, 10, 10), 3, 5
    ids, feats = make_sparse(rng, 2, 100, dims, cin)
    od = _out_dims(dims, kernel, stride, padding)
    k = int(np.prod(kernel if isinstance(kernel, tuple) else (kernel,) * 3))
    w = rng.normal(0, 0.3, (k, cin, cout)).astype(np.float32)
    out_ids = js.strided_output_ids(jnp.asarray(ids), dims, od, kernel, stride, padding, budget=60)
    want = np.asarray(js.strided_conv_apply(jnp.asarray(ids), jnp.asarray(feats), out_ids, dims, od,
                                            kernel, stride, padding, jnp.asarray(w)))
    got = ts.strided_conv_apply(_t(ids), _t(feats), _t(out_ids), dims, od, kernel, stride, padding,
                                _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sparse_to_dense_and_height_compression_match_jax():
    rng = np.random.default_rng(5)
    dims, c = (2, 6, 8), 4
    ids, feats = make_sparse(rng, 2, 60, dims, c)
    want = np.asarray(js.sparse_to_dense(jnp.asarray(ids), jnp.asarray(feats), dims))
    np.testing.assert_array_equal(ts.sparse_to_dense(_t(ids), _t(feats), dims).numpy(), want)
    cfg = {"NAME": "HeightCompression", "NUM_BEV_FEATURES": c * dims[0]}
    jout = JaxHC(model_cfg=cfg, grid_size=(8, 6, 4)).apply(
        {}, {"encoded_spconv_tensor": (jnp.asarray(ids), jnp.asarray(feats)),
             "encoded_spconv_dims": dims})
    tout = HeightCompression(cfg, (8, 6, 4))({"encoded_spconv_tensor": (_t(ids), _t(feats)),
                                              "encoded_spconv_dims": dims})
    np.testing.assert_array_equal(tout["spatial_features"].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jout["spatial_features"]))


@pytest.mark.parametrize("max_voxels", [None, 300])
def test_dynamic_mean_vfe_matches_jax(max_voxels):
    """11 features of 13 on the SECOND grid shape (z 40 + 1) at a small xy
    extent: points sharing voxels, a padding tail, points outside the range;
    with MAX_VOXELS 300 under the occupied voxels."""
    rng = np.random.default_rng(6)
    b, n = 2, 1500
    pts = rng.uniform(0, 1, (b, n, 13)).astype(np.float32)
    pts[..., 0:2] = rng.uniform(-3.2, 3.2, (b, n, 2))
    pts[..., 2] = rng.uniform(-8.0, 0.0, (b, n))
    pts[:, 500:900, 0:3] = pts[:, 0:400, 0:3] + rng.uniform(-0.02, 0.02, (b, 400, 3))
    pts[:, :20, 0] = 4.0  # outside the range
    pts[:, 20:30, 2] = 0.5
    mask = np.ones((b, n), bool)
    mask[1, -200:] = False
    cfg = {"NAME": "DynMeanVFE", "NUM_POINT_FEATURES": 11}
    if max_voxels:
        cfg["MAX_VOXELS"] = max_voxels
    kw = dict(model_cfg=cfg, num_point_features=13, voxel_size=(0.1, 0.1, 0.2),
              grid_size=(64, 64, 40), point_cloud_range=(-3.2, -3.2, -8.0, 3.2, 3.2, 0.0))
    jout = JaxMeanVFE(**kw).apply({}, {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    tout = DynamicMeanVFE(**kw)({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})
    jids = np.asarray(jout["voxel_ids"])
    limit = 41 * 64 * 64
    assert tout["sparse_dims"] == tuple(jout["sparse_dims"]) == (41, 64, 64)
    occupied = (jids < limit).sum(1)
    assert (occupied == max_voxels).all() if max_voxels else (occupied > 600).all()
    np.testing.assert_array_equal(tout["voxel_ids"].numpy(), jids)
    np.testing.assert_allclose(tout["voxel_features"].numpy(), np.asarray(jout["voxel_features"]),
                               atol=1e-6, rtol=1e-6)
