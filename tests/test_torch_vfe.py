"""The port's DynamicPillarVFE against the JAX package's sorted pipeline.

13-feature points of which the VFE reads 11, the same weights (carried across
by the bridge) and randomised BN running statistics. ``pillar_features`` must
agree within atol 2e-4, rtol 1e-4 (tests/test_full_model_parity.py:169).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models.vfe.dynamic_pillar_vfe import DynamicPillarVFE as JaxVFE
from pcp_tpu_torch.models.vfe.dynamic_pillar_vfe import DynamicPillarVFE, pillar_ids
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables
from torch_port_helpers import (GRID, NUM_FEATURES, NUM_RAW, PC_RANGE, VOXEL, clustered_points,
                                randomize_batch_stats)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

VFE_CFG = {"NAME": "DynPillarVFE", "NUM_RAW_POINT_FEATURES": NUM_RAW, "WITH_DISTANCE": False,
           "USE_ABSLOTE_XYZ": True, "USE_NORM": True, "NUM_FILTERS": [32, 32]}
GEOM = dict(num_point_features=NUM_FEATURES, voxel_size=VOXEL, grid_size=(GRID, GRID, 1),
            point_cloud_range=PC_RANGE)


def _points(case, rng):
    b, n = 2, 2500
    pts = clustered_points(rng, b, n, spread=2.0)
    mask = np.ones((b, n), bool)
    if case == "padding_and_out_of_range":
        mask[0, -400:] = False
        pts[1, :300, 0] = rng.uniform(13.0, 20.0, 300)  # beyond the x range
        pts[1, 300:500, 1] = rng.uniform(-20.0, -12.9, 200)  # below the y range
    elif case == "pillar_borders":
        k = rng.integers(0, GRID, size=(b, n, 2))
        pts[..., 0:2] = (np.float32(PC_RANGE[0]) + k * np.float32(VOXEL[0])).astype(np.float32)
    elif case == "empty":
        mask[:] = False
    return pts, mask


@pytest.fixture(scope="module")
def vfe_pair():
    rng = np.random.default_rng(1)
    jvfe = JaxVFE(model_cfg=CfgDict(VFE_CFG), **GEOM)
    pts, mask = _points("plain", rng)
    init = jvfe.init(jax.random.PRNGKey(2), {"points": jnp.asarray(pts),
                                             "points_mask": jnp.asarray(mask)}, train=False)
    variables = {"params": {"vfe": jax.tree_util.tree_map(np.asarray, init["params"])},
                 "batch_stats": {"vfe": randomize_batch_stats(init["batch_stats"], rng)}}
    sd = state_dict_from_jax_variables(variables, {"VFE": VFE_CFG})
    tvfe = DynamicPillarVFE(VFE_CFG, **GEOM).eval()
    tvfe.load_state_dict({k[len("vfe."):]: v for k, v in sd.items()}, strict=True)
    jvars = {"params": variables["params"]["vfe"], "batch_stats": variables["batch_stats"]["vfe"]}
    return jvfe, jvars, tvfe


CASES = ["plain", "padding_and_out_of_range", "pillar_borders", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_pillar_features_match(vfe_pair, case):
    jvfe, jvars, tvfe = vfe_pair
    pts, mask = _points(case, np.random.default_rng(10 + CASES.index(case)))
    want = np.asarray(jvfe.apply(jvars, {"points": jnp.asarray(pts),
                                         "points_mask": jnp.asarray(mask)},
                                 train=False)["pillar_features"])
    with torch.inference_mode():
        got = tvfe({"points": torch.from_numpy(pts),
                    "points_mask": torch.from_numpy(mask)})["pillar_features"].numpy()
    assert got.shape == want.shape == (2, GRID * GRID, 32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    if case == "empty":
        assert not got.any()


def test_pids_match_on_pillar_borders():
    rng = np.random.default_rng(4)
    pts, mask = _points("pillar_borders", rng)
    want = JaxVFE(model_cfg=CfgDict(VFE_CFG), **GEOM)._coords_and_pid(
        jnp.asarray(pts[..., :NUM_RAW]), jnp.asarray(mask))[2]
    got = pillar_ids(torch.from_numpy(pts[..., :NUM_RAW]), torch.from_numpy(mask),
                     PC_RANGE, VOXEL, (GRID, GRID, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PRE_REDUCE = [True, "fused", "Fused", "onehot"]


@pytest.fixture(scope="module")
def pre_reduce_pairs(vfe_pair):
    """The JAX and the port's VFE under each PRE_REDUCE value, with the
    weights of ``vfe_pair`` (the setting adds no parameter)."""
    _, jvars, tvfe = vfe_pair
    pairs = {}
    for value in PRE_REDUCE:
        cfg = dict(VFE_CFG, PRE_REDUCE=value)
        port = DynamicPillarVFE(cfg, **GEOM).eval()
        port.load_state_dict(tvfe.state_dict(), strict=True)
        pairs[value] = (JaxVFE(model_cfg=CfgDict(cfg), **GEOM), port)
    return jvars, pairs


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("value", PRE_REDUCE, ids=[repr(v) for v in PRE_REDUCE])
def test_pillar_features_match_under_pre_reduce(pre_reduce_pairs, value, case):
    jvars, pairs = pre_reduce_pairs
    jvfe, tvfe = pairs[value]
    pts, mask = _points(case, np.random.default_rng(10 + CASES.index(case)))
    want = np.asarray(jvfe.apply(jvars, {"points": jnp.asarray(pts),
                                         "points_mask": jnp.asarray(mask)},
                                 train=False)["pillar_features"])
    with torch.inference_mode():
        got = tvfe({"points": torch.from_numpy(pts),
                    "points_mask": torch.from_numpy(mask)})["pillar_features"].numpy()
    assert got.shape == want.shape == (2, GRID * GRID, 32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    if case == "empty":
        assert not got.any()


@pytest.mark.parametrize("value", PRE_REDUCE, ids=[repr(v) for v in PRE_REDUCE])
def test_pre_reduce_equals_default_path(vfe_pair, pre_reduce_pairs, value):
    """Each setting's scatter function, and through it the same
    ``pillar_features`` as the port's default path: exactly, the one-hot
    variant within rtol 1.2e-7."""
    from pcp_tpu_torch.ops import bev_scatter

    want_fn = {True: bev_scatter.bev_scatter_max_sorted_prereduced,
               "fused": bev_scatter.bev_scatter_max_sorted_fused,
               "onehot": bev_scatter.bev_scatter_max_sorted_onehot}[
                   value.lower() if isinstance(value, str) else value]
    tvfe = pre_reduce_pairs[1][value][1]
    assert tvfe.scatter_max is want_fn
    assert vfe_pair[2].scatter_max is bev_scatter.bev_scatter_max_sorted
    pts, mask = _points("padding_and_out_of_range", np.random.default_rng(21))
    batch = {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)}
    with torch.inference_mode():
        got = tvfe(batch)["pillar_features"].numpy()
        want = vfe_pair[2](batch)["pillar_features"].numpy()
    assert want.any()
    if want_fn is bev_scatter.bev_scatter_max_sorted_onehot:
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_pre_reduce_and_training_raise(vfe_pair):
    """Training no longer raises: under ``PRE_REDUCE: fused`` the VFE in
    training mode (masked batch statistics, padding and out-of-range points)
    gives the JAX VFE's pillar features and running statistics (rtol 1e-5)."""
    jvfe, jvars, tvfe = vfe_pair
    pts, mask = _points("padding_and_out_of_range", np.random.default_rng(0))
    batch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    want, upd = JaxVFE(model_cfg=CfgDict(dict(VFE_CFG, PRE_REDUCE="fused")), **GEOM).apply(
        jvars, batch, train=True, mutable=["batch_stats"])
    vfe = DynamicPillarVFE(dict(VFE_CFG, PRE_REDUCE="fused"), **GEOM)
    vfe.load_state_dict(tvfe.state_dict())
    got = vfe.train()({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(got["pillar_features"].detach().numpy(),
                               np.asarray(want["pillar_features"]), atol=2e-4, rtol=1e-4)
    for i in range(2):
        for key, stat in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(getattr(vfe.pfn_layers[i].norm, stat).numpy(),
                                       np.asarray(upd["batch_stats"][f"pfn_{i}"]["norm"][key]),
                                       rtol=1e-5, atol=1e-6)
