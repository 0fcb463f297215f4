"""The weight bridge: JAX variables -> the port's pcdet-named state dict.

Round trip: ``state_dict_from_jax_variables`` followed by the JAX package's
``convert_centerpoint_state_dict`` gives back the original variables bit for
bit, for a small model and for the committed trained checkpoint, which then
loads into the full-width ego model built from its YAML with strict=True.
The senders (car and RSU, with the HunterJr corrector) make the same round
trip at small size and at full width from their YAML, and gradient-shaped
trees map onto their parameters.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict, cfg_from_yaml_file
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.utils.torch_converter import convert_centerpoint_state_dict
from pcp_tpu_torch.entry import CFG_CAR, CFG_EGO, CFG_RSU, build
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from torch_port_helpers import CAR_CFG, CAR_FEATURES, MODEL_CFG, build_pair

CKPT = os.path.join(os.path.dirname(__file__), "..", "results", "bench_ckpt")


def _assert_round_trip(variables, model_cfg):
    sd = state_dict_from_jax_variables(variables, model_cfg)
    back = convert_centerpoint_state_dict({k: v.numpy() for k, v in sd.items()}, model_cfg)
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(got) == len(want), col
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
            assert got[path].dtype == np.asarray(leaf).dtype
    return sd


def test_round_trip_small_model():
    _, variables, tmodel = build_pair(seed=5)
    sd = _assert_round_trip(variables, MODEL_CFG)
    assert set(sd) == set(tmodel.state_dict())


@pytest.fixture(scope="module")
def ckpt_variables():
    from pcp_tpu.train.checkpoint import load_params_from_file

    return jax.tree_util.tree_map(np.asarray, load_params_from_file(os.path.abspath(CKPT)))


def test_trained_checkpoint_loads_into_full_width_ego(ckpt_variables):
    cfg, info, model = build(CFG_EGO, device="cpu")
    assert info.grid_size == (512, 512, 1) and info.num_point_features == 13
    sd = _assert_round_trip(ckpt_variables, cfg.MODEL)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert model.backbone_2d.blocks[2][1].weight.shape == (256, 128, 3, 3)


def test_round_trip_small_sender():
    """The sender's structure at small size: JAX variables -> port state dict
    -> JAX variables, leaf for leaf, and every key of the port's model."""
    _, variables, tmodel = build_pair(seed=6, model_cfg=CAR_CFG, num_features=CAR_FEATURES)
    sd = _assert_round_trip(variables, CAR_CFG)
    assert set(sd) == set(tmodel.state_dict())
    assert any(k.startswith("corrector.conv_weightor.0.1.running_var") for k in sd)


@pytest.mark.parametrize("cfg_path", [CFG_CAR, CFG_RSU], ids=["car", "rsu"])
def test_sender_yaml_round_trip(cfg_path):
    """The full-width car and RSU models from their YAML: a port state dict
    through ``convert_centerpoint_state_dict`` gives a tree with the JAX
    model's structure and shapes (``jax.eval_shape`` of its init), which
    the bridge turns back into the same state dict, leaf for leaf, and which
    loads with strict=True."""
    cfg, _, model = build(cfg_path, device="cpu")
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    variables = convert_centerpoint_state_dict({k: v.numpy() for k, v in sd.items()}, cfg.MODEL)

    jcfg = cfg_from_yaml_file(cfg_path, CfgDict())
    jinfo = JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    jmodel = build_jax(jcfg.MODEL, num_class=1, dataset_info=jinfo)
    batch = {"points": jnp.zeros((1, 64, 7)), "points_mask": jnp.ones((1, 64), bool),
             "batch_size": 1}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, batch, train=False), jax.random.PRNGKey(0))
    for col in ("params", "batch_stats"):
        want = {p: leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(shapes[col])}
        got = {p: leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}
        assert got == want, col

    back = state_dict_from_jax_variables(variables, cfg.MODEL)
    assert set(back) == set(model.state_dict())
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    result = model.load_state_dict(back, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert model.corrector.conv_input[0].weight.shape == (384, 384, 3, 3)


def test_tensors_from_jax_params_maps_the_corrector():
    """A gradient-shaped tree of the sender's params maps onto the port's
    parameter names (the corrector's included), and back through the JAX
    package's converter to the same tree, leaf for leaf."""
    _, variables, tmodel = build_pair(seed=8, model_cfg=CAR_CFG, num_features=CAR_FEATURES)
    rng = np.random.default_rng(8)
    grads = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), variables["params"])
    tensors = tensors_from_jax_params(grads, CAR_CFG)
    assert set(tensors) == {n for n, _ in tmodel.named_parameters()}
    assert any(k.startswith("corrector.point_head.seg.") for k in tensors)
    stats = {k: v for k, v in state_dict_from_jax_variables(variables, CAR_CFG).items()
             if "running_" in k}
    back = convert_centerpoint_state_dict({k: v.numpy() for k, v in {**tensors, **stats}.items()},
                                          CAR_CFG)["params"]
    want = jax.tree_util.tree_leaves_with_path(grads)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
