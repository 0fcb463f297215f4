"""The port's train step against the JAX package's, on the small model.

The ego config's structure at reduced size (tests/torch_port_helpers.py), the
same weights, points and gt boxes in both packages; the JAX side runs its
Pallas kernel in interpret mode. Held: loss and tb values of one training
forward (rtol 1e-5), every parameter gradient (each leaf within 3e-3 of its
largest |g|: a ReLU whose input lies within float32 rounding of 0 passes the
gradient in one package and not in the other, and the convolutions round
differently; seen up to 1.4e-3; conv biases in front of a BN, whose gradient
is 0 in exact arithmetic, within 1e-6 of the model's largest |g|), the
running statistics of both BN conventions after it (atol 1e-6), and the loss
of 5 train steps against ``make_train_step`` (rtol 1e-4).

The JAX gradient of the VFE's parameters is taken without ``jax.jit``: on
the sorted path in training mode, the jitted gradient of the JAX package
disagrees with its own eager gradient and with central differences on this
CPU (ROADMAP C). The eager one is what the VFE is held to, through the
cotangent that the jitted rest of the model sends to the BEV; the port's VFE
gradient is also held to central differences.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models.vfe.dynamic_pillar_vfe import DynamicPillarVFE as JaxVFE
from pcp_tpu.train.optimization import build_optimizer as jax_build_optimizer
from pcp_tpu.train.train_state import create_train_state as jax_create_train_state
from pcp_tpu.train.train_state import make_train_step as jax_make_train_step
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.ops import bev_scatter
from pcp_tpu_torch.train.optimization import build_optimizer
from pcp_tpu_torch.train.train_state import TrainState, biases_before_bn, make_train_step
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from torch_port_helpers import (B, MODEL_CFG, OPTIM, build_pair, info_kwargs, jax_batch,
                                make_train_batch, torch_batch)

STEPS = 5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def one_step():
    """One training forward and backward in both packages."""
    rng = np.random.default_rng(7)
    pts, mask, gt = make_train_batch(rng)
    jmodel, variables, tmodel = build_pair(seed=3)
    jb = jax_batch(pts, mask, gt)

    def loss_fn(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb,
                                train=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], upd["batch_stats"], out["spatial_features"])

    (jloss, (jtb, jstats, spatial)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    def tail_loss(spatial):
        bound = jmodel.bind(variables, mutable=["batch_stats"])
        d = dict(jb, spatial_features=spatial)
        for module in bound.module_list[2:]:
            d = module(d, train=True)
        return bound.module_list[-1].get_loss(d["head_preds"], d["head_targets"])[0]

    cotangent = jax.jit(jax.grad(tail_loss))(spatial).reshape(B, -1, spatial.shape[-1])
    info = info_kwargs()
    jvfe = JaxVFE(model_cfg=MODEL_CFG["VFE"], num_point_features=info["num_point_features"],
                  voxel_size=info["voxel_size"], grid_size=info["grid_size"],
                  point_cloud_range=info["point_cloud_range"])

    def vfe_out(params):
        out, _ = jvfe.apply({"params": params, "batch_stats": variables["batch_stats"]["vfe"]}, jb,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out["pillar_features"] * cotangent)

    jgrads = dict(_np(jgrads), vfe=_np(jax.grad(vfe_out)(variables["params"]["vfe"])))  # eager

    tmodel.train()
    bev_scatter.reset_launches()
    out = tmodel(torch_batch(pts, mask, gt))
    out["loss"].backward()
    return {"jax": {"loss": float(jloss), "tb": {k: float(v) for k, v in jtb.items()},
                    "grads": tensors_from_jax_params(jgrads, MODEL_CFG),
                    "state": state_dict_from_jax_variables(
                        {"params": variables["params"], "batch_stats": _np(jstats)}, MODEL_CFG)},
            "torch": {"loss": out["loss"].item(), "tb": {k: v.item() for k, v in out["tb_dict"].items()},
                      "grads": {n: p.grad for n, p in tmodel.named_parameters()},
                      "state": tmodel.state_dict(), "launches": dict(bev_scatter.launches)},
            "model": tmodel, "batch": (pts, mask, gt)}


def test_loss_and_tb_match(one_step):
    j, t = one_step["jax"], one_step["torch"]
    assert set(t["tb"]) == set(j["tb"]) == {"hm_loss_head_0", "loc_loss_head_0", "rpn_loss"}
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    for key, value in j["tb"].items():
        assert t["tb"][key] == pytest.approx(value, rel=1e-5), key
    assert not any(t["launches"].values())  # the CPU takes the plain versions


GROUPS = ("vfe", "backbone_2d", "dense_head")


@pytest.mark.parametrize("group", GROUPS)
def test_parameter_gradients_match(one_step, group):
    want, got, model = one_step["jax"]["grads"], one_step["torch"]["grads"], one_step["model"]
    names = [n for n in got if n.startswith(group + ".")]
    assert names and set(names) == {n for n in want if n.startswith(group + ".")}
    top = max(v.abs().max().item() for v in want.values())
    before_bn = biases_before_bn(model)
    for name in names:
        g, w = got[name], want[name]
        assert g.shape == w.shape, name
        if name in before_bn:
            assert g.abs().max().item() <= 1e-6 * top and w.abs().max().item() <= 1e-6 * top, name
            continue
        err = (g - w).abs().max().item()
        assert err <= 3e-3 * w.abs().max().item(), (name, err, w.abs().max().item())


@pytest.mark.parametrize("group", GROUPS)
def test_running_statistics_match(one_step, group):
    want, got = one_step["jax"]["state"], one_step["torch"]["state"]
    names = [n for n in got if n.startswith(group + ".") and ".running_" in n]
    assert names
    for name in names:
        torch.testing.assert_close(got[name], want[name], atol=1e-6, rtol=0, msg=name)


def test_vfe_gradient_matches_central_differences(one_step):
    """d loss / d (BN bias) of both PFN layers, the largest entry of each:
    the port's backward (the tie-splitting scatter backward and the segment
    max included) against central differences of its own loss, both in
    float64 (step 1e-6, rtol 1e-6: larger steps cross ReLU and max kinks, and
    at 1e-4 the difference quotient is off by 1.4%). This holds the backward
    to the derivative. The float32 gradient of the fixture is not compared:
    on this entry it is 14% from the float64 one (the pillar ids are the
    same; ReLU and max kinks lie within rounding of the float32 point)."""
    model = copy.deepcopy(one_step["model"]).double()
    pts, mask, gt = one_step["batch"]
    batch = torch_batch(pts.astype(np.float64), mask, gt.astype(np.float64))
    model.zero_grad()
    model(batch)["loss"].backward()
    for layer in (0, 1):
        name = f"vfe.pfn_layers.{layer}.norm.bias"
        bias = model.get_parameter(name)
        c = int(one_step["torch"]["grads"][name].abs().argmax())
        losses = []
        for s in (1e-6, -1e-6):
            with torch.no_grad():
                bias[c] += s
                losses.append(model(batch)["loss"].item())
                bias[c] -= s
        fd = (losses[0] - losses[1]) / 2e-6
        assert bias.grad[c].item() == pytest.approx(fd, rel=1e-6), name


def test_five_train_steps_match(one_step):
    """``make_train_step`` of both packages from the same state: adam_onecycle
    with the ego config's settings, the same batch five times."""
    pts, mask, gt = one_step["batch"]
    jmodel, variables, tmodel = build_pair(seed=3)
    tx, _ = jax_build_optimizer(CfgDict(OPTIM), total_iters_each_epoch=STEPS, total_epochs=1)
    jstate = jax_create_train_state(jmodel, tx, jax.random.PRNGKey(0), jax_batch(pts, mask, gt))
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    jstep = jax_make_train_step(jmodel, tx, donate=False)
    jlosses = []
    for _ in range(STEPS):
        jstate, loss, _ = jstep(jstate, jax_batch(pts, mask, gt))
        jlosses.append(float(loss))

    optimizer, _ = build_optimizer(TorchCfgDict(OPTIM), tmodel, total_iters_each_epoch=STEPS,
                                   total_epochs=1)
    state = TrainState(tmodel, optimizer)
    step = make_train_step(tmodel, optimizer)
    losses = [step(torch_batch(pts, mask, gt))[0].item() for _ in range(STEPS)]
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
