"""The weight bridge: JAX variables -> the port's pcdet-named state dict.

Round trip: ``state_dict_from_jax_variables`` followed by the JAX package's
``convert_centerpoint_state_dict`` gives back the original variables bit for
bit, for a small model and for the committed trained checkpoint, which then
loads into the full-width ego model built from its YAML with strict=True.
The senders (car and RSU, with the HunterJr corrector) make the same round
trip at small size and at full width from their YAML, with the object head
(a training-mode tree, which a JAX training apply accepts) and without it
(an eval-mode init's), and gradient-shaped trees map onto their parameters.
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
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.entry import CFG_CAR, CFG_EGO, CFG_RSU, build
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.models import build_network
from pcp_tpu_torch.train.train_state import init_weights
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from torch_port_helpers import CAR_CFG, CAR_FEATURES, MODEL_CFG, build_pair, info_kwargs


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

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
    """The sender's structure at small size: JAX variables of an eval-mode
    init -> port state dict -> JAX variables, leaf for leaf. Such variables
    have no object head (only training calls it): the state dict holds every
    key of the port's model but the object head's."""
    _, variables, tmodel = build_pair(seed=6, model_cfg=CAR_CFG, num_features=CAR_FEATURES)
    assert "object_head" not in variables["params"]["corrector"]
    sd = _assert_round_trip(variables, CAR_CFG)
    object_head = {k for k in tmodel.state_dict() if k.startswith("corrector.object_head.")}
    assert object_head and set(sd) == set(tmodel.state_dict()) - object_head
    assert any(k.startswith("corrector.conv_weightor.0.1.running_var") for k in sd)


def _sender_train_batch(n=64):
    """A batch that reaches the JAX sender's training branch."""
    return {"points": jnp.zeros((1, n, 7)), "points_mask": jnp.ones((1, n), bool),
            "gt_boxes": jnp.zeros((1, 4, 8)), "instances_tf": jnp.tile(jnp.eye(4), (1, 3, 11, 1, 1)),
            "batch_size": 1}


def test_object_head_round_trip_into_a_jax_training_apply():
    """Port state dict with the object head -> ``convert_centerpoint_state_dict``
    -> JAX variables with the tree of a training-mode init, which a training
    apply accepts (finite loss, the object head's loss terms present), and
    back through the bridge to the same state dict, key for key."""
    cfg, info = CAR_CFG, TorchInfo(**info_kwargs(CAR_FEATURES))
    model = build_network(TorchCfgDict(cfg), num_class=1, dataset_info=info, device="cpu")
    init_weights(model, 3)
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    variables = convert_centerpoint_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    assert set(variables["params"]["corrector"]["object_head"]) == {
        "points_shape_encoder", "local_feat_encoder", "local_tf_decoder"}

    jmodel = build_jax(CfgDict(cfg), num_class=1, dataset_info=JaxInfo(**info_kwargs(CAR_FEATURES)))
    batch = _sender_train_batch()
    shapes = jax.eval_shape(lambda k: jmodel.init(k, batch, train=True), jax.random.PRNGKey(0))
    for col in ("params", "batch_stats"):
        want = {p: leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(shapes[col])}
        got = {p: np.shape(leaf) for p, leaf in jax.tree_util.tree_leaves_with_path(variables[col])}
        assert got == want, col
    rng = np.random.default_rng(4)
    pts = np.asarray(batch["points"]).copy()
    pts[0, :, 0:3] = rng.uniform(-10, 10, (64, 3))
    pts[0, :, 5] = rng.integers(0, 11, 64)
    pts[0, :, 6] = rng.integers(-1, 3, 64)
    out, _ = jax.jit(lambda v, b: jmodel.apply(v, b, train=True, mutable=["batch_stats"]))(
        variables, dict(batch, points=jnp.asarray(pts)))
    assert np.isfinite(float(out["loss"])) and "l_locals_rot" in out["tb_dict"]

    back = state_dict_from_jax_variables(variables, cfg)
    assert set(back) == set(model.state_dict())
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    model.load_state_dict(back, strict=True)


@pytest.mark.parametrize("cfg_path", [CFG_CAR, CFG_RSU], ids=["car", "rsu"])
def test_sender_yaml_round_trip(cfg_path):
    """The full-width car and RSU models from their YAML: a port state dict
    through ``convert_centerpoint_state_dict`` gives a tree with the JAX
    model's structure and shapes (``jax.eval_shape`` of its training-mode
    init, the object head included), which the bridge turns back into the
    same state dict, leaf for leaf, and which loads with strict=True."""
    cfg, _, model = build(cfg_path, device="cpu")
    rng = np.random.default_rng(7)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    variables = convert_centerpoint_state_dict({k: v.numpy() for k, v in sd.items()}, cfg.MODEL)

    jcfg = cfg_from_yaml_file(cfg_path, CfgDict())
    jinfo = JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    jmodel = build_jax(jcfg.MODEL, num_class=1, dataset_info=jinfo)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, _sender_train_batch(), train=True),
                            jax.random.PRNGKey(0))
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
    _, _, tmodel = build_pair(seed=8, model_cfg=CAR_CFG, num_features=CAR_FEATURES)
    # a training-mode tree, the object head included
    variables = convert_centerpoint_state_dict(
        {k: v.numpy() for k, v in tmodel.state_dict().items()}, CAR_CFG)
    rng = np.random.default_rng(8)
    grads = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), variables["params"])
    tensors = tensors_from_jax_params(grads, CAR_CFG)
    assert set(tensors) == {n for n, _ in tmodel.named_parameters()}
    assert any(k.startswith("corrector.point_head.seg.") for k in tensors)
    assert any(k.startswith("corrector.object_head.local_tf_decoder.") for k in tensors)
    stats = {k: v for k, v in state_dict_from_jax_variables(variables, CAR_CFG).items()
             if "running_" in k}
    back = convert_centerpoint_state_dict({k: v.numpy() for k, v in {**tensors, **stats}.items()},
                                          CAR_CFG)["params"]
    want = jax.tree_util.tree_leaves_with_path(grads)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
