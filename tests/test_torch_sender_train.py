"""Training the senders: the port's HunterJr losses and the car's training
step against the JAX package.

The same numpy-seeded inputs go through the JAX function and the port's;
gradients are eager ``jax.grad`` where the text does not say otherwise (the
jitted VFE gradient of the JAX package disagrees with its own eager one,
ROADMAP C). Tolerances, per test:

* ``quat2mat``: values and gradients atol 1e-6 / rtol 1e-6 (the same
  float32 arithmetic).
* ``hard_mining_regression_loss``: value rtol 1e-6, gradients exact (each is
  1/count or 0, so a tie at the cut that the two sorts broke differently
  would show as a whole entry).
* ``ce_lovasz_loss``: value rtol 1e-5, gradients atol 1e-7 + rtol 1e-4
  (sums over the sorted errors in another order).
* ``HunterObjectHead``: outputs atol 1e-5 / rtol 1e-5, gradients within
  1e-5 of each leaf's largest |g|.
* The car's whole training forward at small size (``CAR_CFG``) on
  ``tests/test_hunter_jr.py::make_sweep_batch``'s layout, the port's seeded
  initial weights with random BN affine parameters and statistics carried to
  JAX by ``convert_centerpoint_state_dict``, once with foreground and a
  teacher BEV and once with no foreground at all: loss and every tb key rtol
  1e-5 (seen 2.1e-6); running statistics atol 1e-6 (seen 2.4e-7); every
  gradient leaf within 1e-2 of its largest |g| (seen 4.3e-3: the two
  backbones' BEVs differ by float32 rounding, which the corrector's point
  head amplifies, and a ReLU input within rounding of 0 passes the gradient
  in one package only); the corrector alone, fed the JAX backbone's BEV and
  the JAX head's cotangent on its output, every leaf within 1e-4 (seen
  7.8e-6); leaves whose gradient is 0 in exact arithmetic within 1e-6 of
  the model's largest |g| on both sides.

The JAX gradients of the VFE and of the corrector are eager; those of the
backbone and the head are jitted (within 1e-5 of the eager ones on this
model at its initial weights); the forward, its loss, tb and statistics are jitted.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.bev_layers import hunter_jr as jhj
from pcp_tpu.models.bev_layers import hunter_toolbox as jtb
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.models.loss_fnc import lovasz as jlv
from pcp_tpu.models.vfe.dynamic_pillar_vfe import DynamicPillarVFE as JaxVFE
from pcp_tpu.utils.torch_converter import convert_centerpoint_state_dict
from pcp_tpu_torch.config import CfgDict as TorchCfgDict
from pcp_tpu_torch.models import DatasetInfo as TorchInfo
from pcp_tpu_torch.models import build_network as build_torch
from pcp_tpu_torch.models.bev_layers import hunter_toolbox as ttb
from pcp_tpu_torch.models.bev_layers.hunter_jr import HunterObjectHead
from pcp_tpu_torch.models.loss_fnc import lovasz as tlv
from pcp_tpu_torch.train.train_state import init_weights
from pcp_tpu_torch.utils.jax_weights import put_mlp, state_dict_from_jax_variables, tensors_from_jax_params
from test_hunter_jr import make_sweep_batch
from torch_port_helpers import (CAR_CFG, CAR_FEATURES, exact_zero_leaves, info_kwargs,
                                randomize_batch_stats)

CORRECTOR_KEYS = {"corrector_loss", "l_points_cls", "l_points_embed", "l_fg_offset",
                  "l_locals_transl", "l_locals_rot", "l_recon", "l_dtl_locals_feat"}
HEAD_KEYS = {"hm_loss_head_0", "loc_loss_head_0", "rpn_loss"}
# a corrector decision this close to its boundary may fall either way between
# the packages, whose probabilities and point coords agree to about 1e-6 here
DECISION_BAND = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_bn_affine(tree, rng):
    """BN scale U(0.8, 1.2) and bias N(0, 0.1) in a flax params tree. At
    the initial scale 1 and bias 0 a local of one point lies on a ReLU kink
    in the shape encoder (its centred xyz is exactly 0, so its normalised
    value is the batch mean's rounding error), where the two packages may
    take either side."""
    out = {}
    for k, v in tree.items():
        if k.startswith("norm") and "scale" in v:
            out[k] = {"scale": rng.uniform(0.8, 1.2, np.shape(v["scale"])).astype(np.float32),
                      "bias": rng.normal(0, 0.1, np.shape(v["bias"])).astype(np.float32)}
        elif isinstance(v, dict) or hasattr(v, "items"):
            out[k] = randomize_bn_affine(v, rng)
        else:
            out[k] = v
    return out


# ----------------------------------------------------------- toolbox ops

def test_quat2mat_matches_jax():
    """Unnormalised quaternions (the reference does not normalise):
    values and the gradient of a random functional."""
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((64, 4)) * rng.uniform(0.2, 3.0, (64, 1))).astype(np.float32)
    w = rng.standard_normal((64, 3, 3)).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda x: jnp.sum(jtb.quat2mat(x) * w))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_(True)
    got = ttb.quat2mat(tq)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jtb.quat2mat(jnp.asarray(q))),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=1e-6)
    eye = ttb.quat2mat(torch.tensor([0.0, 0.0, 0.0, 1.0]))
    assert torch.equal(eye, torch.eye(3))


def _miner_case(name, rng):
    """(losses, positive mask, valid mask, ratio) with ties among the
    negatives, across the cut of the top-k."""
    n = 300
    loss = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0, 3.5]), size=n).astype(np.float32)
    loss[::7] = rng.uniform(0, 4, size=loss[::7].shape)
    valid = rng.uniform(size=n) < 0.85
    pos = rng.uniform(size=n) < 0.1
    ratio = 1
    if name == "no_positive":
        pos[:] = False
    elif name == "ratio_3":
        ratio = 3
    elif name == "k_over_negatives":
        pos = rng.uniform(size=n) < 0.7
        ratio = 2
    elif name == "no_valid":
        valid[:] = False
    elif name == "all_tied":
        loss[:] = 1.5
    return loss, pos, valid, ratio


@pytest.mark.parametrize("case", ["with_positives", "no_positive", "ratio_3", "k_over_negatives",
                                  "no_valid", "all_tied"])
def test_hard_mining_regression_loss_matches_jax(case):
    loss, pos, valid, ratio = _miner_case(case, np.random.default_rng(len(case)))
    jf = lambda x: jtb.hard_mining_regression_loss(x, jnp.asarray(pos), jnp.asarray(valid), ratio)  # noqa: E731
    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(loss))
    tl = torch.from_numpy(loss).requires_grad_(True)
    got = ttb.hard_mining_regression_loss(tl, torch.from_numpy(pos), torch.from_numpy(valid), ratio)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    np.testing.assert_array_equal(tl.grad.numpy(), np.asarray(jgrad))
    if case not in ("no_valid",):
        assert tl.grad.abs().sum() > 0


@pytest.mark.parametrize("case", ["mixed", "tied_errors", "one_class_absent"])
def test_ce_lovasz_loss_matches_jax(case):
    """Padding rows, tied errors (repeated logit rows), a class absent."""
    rng = np.random.default_rng(len(case))
    n = 400
    logits = rng.standard_normal((n, 3)).astype(np.float32) * 2
    labels = rng.integers(0, 3, n)
    valid = np.ones(n, bool)
    valid[-60:] = False
    labels[-60:] = rng.integers(-1, 3, 60)
    if case == "tied_errors":
        logits[::2] = logits[0]
        logits[1::4] = 0.0
    elif case == "one_class_absent":
        labels[labels == 2] = 0
    want, jgrad = jax.value_and_grad(lambda x: jlv.ce_lovasz_loss(
        x, jnp.asarray(labels), jnp.asarray(valid), 3))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tlv.ce_lovasz_loss(tl, torch.from_numpy(labels), torch.from_numpy(valid), 3)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), atol=1e-7, rtol=1e-4)
    assert not tl.grad[-60:].any()  # padding rows take no part


# ------------------------------------------------------------ object head

def _object_head_inputs(rng, c=12, n=600, b=2, ni=5, s=4):
    """Foreground rows as the corrector hands them over: post-ReLU
    features with many exact zeros, some rows repeated exactly inside one
    local (ties among updates), invalid rows, locals with one point and
    locals with none."""
    num_locals = b * ni * s
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    feat = np.maximum(rng.standard_normal((n, c)), 0).astype(np.float32)
    feat[rng.uniform(size=n) < 0.2] = 0.0  # whole rows at zero
    lid = rng.integers(0, num_locals - 6, n)  # the last 6 locals stay empty
    lid[:30] = 7
    feat[:30] = feat[0]  # 30 equal rows in local 7
    xyz[:30] = xyz[0] + rng.uniform(-0.5, 0.5, (30, 3)).astype(np.float32)
    lid[30] = num_locals - 6  # one point alone in its local
    valid = rng.uniform(size=n) < 0.9
    valid[:31] = True
    return xyz, feat, lid.astype(np.int32), valid, num_locals, s


def test_object_head_forward_and_gradients_match_jax():
    rng = np.random.default_rng(11)
    c, hidden = 12, (8,)
    xyz, feat, lid, valid, num_locals, s = _object_head_inputs(rng, c)
    jm = jhj.HunterObjectHead(c, hidden)
    args = (jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(lid), jnp.asarray(valid), num_locals, s)
    init = jax.jit(lambda k, *a: jm.init(k, *a, num_locals, s, train=True))(
        jax.random.PRNGKey(2), *args[:4])
    params = randomize_bn_affine(_np(init["params"]), rng)
    stats = randomize_batch_stats(init["batch_stats"], rng)
    w_tf = rng.standard_normal((num_locals, 7)).astype(np.float32)
    w_feat = rng.standard_normal((num_locals, c)).astype(np.float32)

    def jloss(p, f):
        (tf, lf, lv, cent), _ = jm.apply({"params": p, "batch_stats": stats}, args[0], f, *args[2:],
                                         train=True, mutable=["batch_stats"])
        return jnp.sum(tf * w_tf) + jnp.sum(lf * w_feat), (tf, lf, lv, cent)

    (_, jouts), (jgp, jgf) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(feat))

    tm = HunterObjectHead(c, hidden).train()
    sd = {}
    for name in ("points_shape_encoder", "local_feat_encoder", "local_tf_decoder"):
        put_mlp(sd, name, params[name], stats.get(name))
    tm.load_state_dict(sd, strict=True)
    tf_ = torch.from_numpy(feat).requires_grad_(True)
    touts = tm(torch.from_numpy(xyz), tf_, torch.from_numpy(lid).long(), torch.from_numpy(valid),
               num_locals, s)
    ((touts[0] * torch.from_numpy(w_tf)).sum() + (touts[1] * torch.from_numpy(w_feat)).sum()).backward()

    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    lv = touts[2].numpy()
    assert lv.sum() < num_locals and lv[num_locals - 6] and not lv[-1]

    want = {"fg_feat": np.asarray(jgf)}
    for name in ("points_shape_encoder", "local_feat_encoder", "local_tf_decoder"):
        put_mlp(want, name, _np(jgp)[name], None)
    got = {"fg_feat": tf_.grad.numpy(), **{n: p.grad.numpy() for n, p in tm.named_parameters()}}
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err, np.abs(w).max())
    # the tie at zero: local 7's rows are equal, so each takes an equal share
    g7 = tf_.grad.numpy()[:30]
    np.testing.assert_allclose(g7, np.broadcast_to(g7[0], g7.shape), rtol=1e-6, atol=0)


# ------------------------------------------------- the whole car, training

def _teacher(rng, b, h, w, c):
    t = rng.standard_normal((b, h, w, c)).astype(np.float32)
    t[:, ::3] = 0.0  # rows the mask leaves out
    return t


def _torch_batch(jb):
    batch = {k: torch.from_numpy(v) for k, v in jb.items()}
    if "teacher_spatial_features_2d" in batch:  # the port's BEV is (B, C, H, W)
        batch["teacher_spatial_features_2d"] = batch["teacher_spatial_features_2d"].permute(0, 3, 1, 2)
    return batch


def _near_a_decision(model, jb):
    """Valid points whose corrector decision lies within DECISION_BAND of
    its boundary in the port's training forward: the dynamic probability
    against the runner-up where the max is over the threshold, the max
    against the threshold where the dynamic class wins, a moved point's
    coords against a pixel border. Points whose three logits are exactly 0
    (probabilities all 0.5) tie exactly in both packages and stay."""
    model = copy.deepcopy(model).train()
    batch = _torch_batch(jb)
    with torch.no_grad():
        out = model(batch)
    prob, flow = out["points_cls_prob"], out["points_flow3d"]
    best, idx = prob.max(-1)
    exact_tie = (prob == 0.5).all(-1)
    c = model.corrector
    moved, moved_xy = c.move_points(batch["points"][..., 0:2], prob, flow, batch["points_mask"])
    coord = (moved_xy - c.pc_range[:2]) / c.pixel_size
    near = (((prob[..., 2] - prob[..., :2].amax(-1)).abs() < DECISION_BAND)
            & (best > c.thresh_point_cls_prob) & ~exact_tie)
    near |= (idx == 2) & ((best - c.thresh_point_cls_prob).abs() < DECISION_BAND)
    near |= moved[..., 0] & ((coord - coord.round()).abs() < DECISION_BAND).any(-1)
    return near.numpy() & jb["points_mask"]


def _car_case(no_foreground):
    """The port's small car with seeded initial weights, random BN affine
    parameters and running statistics, carried to JAX through
    ``convert_centerpoint_state_dict``, and a sweep batch (2 x 2048) with an
    out-of-range gt box; with foreground also a teacher BEV. No point's
    corrector decision (moved or not, the pixel a moved point lands in) lies
    within DECISION_BAND of its boundary in the port's training forward:
    there either package could take either side, and one such point moves
    the gradient by more than rounding."""
    cfg = copy.deepcopy(CAR_CFG)
    rng = np.random.default_rng(21 + no_foreground)
    tmodel = build_torch(TorchCfgDict(cfg), num_class=1, dataset_info=TorchInfo(**info_kwargs(
        CAR_FEATURES)), device="cpu")
    init_weights(tmodel, 5)
    sd = {k: v.numpy().copy() for k, v in tmodel.state_dict().items()}
    variables = convert_centerpoint_state_dict(sd, cfg)
    variables = {"params": randomize_bn_affine(variables["params"], rng),
                 "batch_stats": randomize_batch_stats(variables["batch_stats"], rng)}
    tmodel.load_state_dict(state_dict_from_jax_variables(variables, cfg), strict=True)

    jb = {k: np.array(v) for k, v in make_sweep_batch(rng, b=2, n=2048).items() if k != "batch_size"}
    jb["gt_boxes"][:, 5] = [13.5, 0.0, -1.0, 4.2, 1.8, 1.6, 0.3, 1.0]  # outside the range
    if no_foreground:
        jb["points"][..., 6] = -1.0
    else:
        jb["teacher_spatial_features_2d"] = _teacher(rng, 2, 32, 32, 48)
    assert not _near_a_decision(tmodel, jb).any()
    return cfg, tmodel, variables, jb


def _jax_side(cfg, variables, jb):
    """Loss, tb and updated statistics from one jitted training forward, and
    the gradients: of the VFE and of the corrector by eager ``jax.grad``
    (the VFE's given the cotangent that reaches its BEV; the corrector's
    given the backbone's BEV and the cotangent that the head sends to the
    blended BEV), of the backbone and the head by the jitted gradient
    (within 1e-5 of the eager one on this model: ROADMAP C's disagreement is
    the VFE's). Also that BEV and cotangent, for the corrector alone."""
    jmodel = build_jax(CfgDict(cfg), num_class=1, dataset_info=JaxInfo(**info_kwargs(CAR_FEATURES)))
    batch = {k: jnp.asarray(v) for k, v in jb.items()}
    batch["batch_size"] = jb["points"].shape[0]
    stats = variables["batch_stats"]

    def forward(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": stats}, batch, train=True,
                                mutable=["batch_stats"])
        return (out["loss"], out["tb_dict"], upd["batch_stats"], out["spatial_features"],
                out["spatial_features_2d"])

    loss, tb, new_stats, spatial, fused = jax.jit(forward)(variables["params"])

    def run(params, spatial, delta):
        """The modules after the VFE, ``delta`` added to the corrector's
        blended BEV (zeros: its gradient is the head's cotangent there).
        Returns (loss, backbone BEV)."""
        bound = jmodel.bind({"params": params, "batch_stats": stats}, mutable=["batch_stats"])
        d = bound.module_list[2](dict(batch, spatial_features=spatial), train=True)
        bev = d["spatial_features_2d"]
        d = bound.module_list[3](d, train=True)
        d = bound.module_list[4](dict(d, spatial_features_2d=d["spatial_features_2d"] + delta),
                                 train=True)
        head = bound.module_list[4].get_loss(d["head_preds"], d["head_targets"])[0]
        return head + d.get("corrector_loss", 0.0), bev

    (grads, cot_spatial, cot_fused), bev = jax.jit(jax.grad(run, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], spatial, jnp.zeros_like(fused))
    grads = _np(grads)

    jcorr = jhj.HunterJr(model_cfg=cfg["CORRECTOR"], info=JaxInfo(**info_kwargs(CAR_FEATURES)),
                         num_bev_features=bev.shape[-1])

    def corrector_out(params):
        out, _ = jcorr.apply({"params": params, "batch_stats": stats["corrector"]},
                             dict(batch, spatial_features_2d=bev), train=True, mutable=["batch_stats"])
        return out.get("corrector_loss", 0.0) + jnp.sum(out["spatial_features_2d"] * cot_fused)

    grads["corrector"] = _np(jax.grad(corrector_out)(variables["params"]["corrector"]))  # eager
    info = info_kwargs(CAR_FEATURES)
    jvfe = JaxVFE(model_cfg=cfg["VFE"], num_point_features=info["num_point_features"],
                  voxel_size=info["voxel_size"], grid_size=info["grid_size"],
                  point_cloud_range=info["point_cloud_range"])
    cot_spatial = cot_spatial.reshape(cot_spatial.shape[0], -1, cot_spatial.shape[-1])

    def vfe_out(params):
        out, _ = jvfe.apply({"params": params, "batch_stats": stats["vfe"]}, batch, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out["pillar_features"] * cot_spatial)

    grads["vfe"] = _np(jax.grad(vfe_out)(variables["params"]["vfe"]))  # eager
    return {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
            "grads": tensors_from_jax_params(grads, cfg),
            "state": state_dict_from_jax_variables({"params": variables["params"],
                                                    "batch_stats": _np(new_stats)}, cfg),
            "bev": np.asarray(bev), "cot_fused": np.asarray(cot_fused)}


def _torch_side(model, jb):
    """One training forward and backward of the whole port model."""
    model = copy.deepcopy(model).train()
    out = model(_torch_batch(jb))
    out["loss"].backward()
    return {"loss": out["loss"].item(), "tb": {k: v.item() for k, v in out["tb_dict"].items()},
            "grads": {n: p.grad for n, p in model.named_parameters()}, "state": model.state_dict(),
            "gt_boxes": out["gt_boxes"], "model": model}


def _torch_corrector(model, jb, bev, cot_fused):
    """The port's corrector alone on the JAX backbone's BEV, its loss plus
    the head's cotangent on the blended BEV: gradients by name."""
    corrector = copy.deepcopy(model.corrector).train()
    batch = dict(_torch_batch(jb), spatial_features_2d=torch.from_numpy(bev).permute(0, 3, 1, 2))
    out = corrector(batch)
    total = (out["spatial_features_2d"] * torch.from_numpy(cot_fused).permute(0, 3, 1, 2)).sum()
    if "corrector_loss" in out:
        total = total + out["corrector_loss"]
    total.backward()
    return {f"corrector.{n}": p.grad for n, p in corrector.named_parameters() if p.grad is not None}


@pytest.fixture(scope="module", params=[False, True], ids=["foreground", "no_foreground"])
def car_step(request):
    cfg, tmodel, variables, jb = _car_case(request.param)
    j = _jax_side(cfg, variables, jb)
    return {"no_fg": request.param, "jax": j,
            "torch": _torch_side(tmodel, jb),
            "corrector": _torch_corrector(tmodel, jb, j["bev"], j["cot_fused"])}


def test_loss_and_tb_match(car_step):
    j, t = car_step["jax"], car_step["torch"]
    want_keys = HEAD_KEYS | CORRECTOR_KEYS | (set() if car_step["no_fg"] else {"l_dtl_bev_img"})
    assert set(t["tb"]) == set(j["tb"]) == want_keys
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    for key, value in j["tb"].items():
        assert np.isfinite(t["tb"][key]), key
        assert t["tb"][key] == pytest.approx(value, rel=1e-5, abs=1e-7), key
    if car_step["no_fg"]:  # the any_fg guards and the miner's no-positive branch
        for key in ("l_points_embed", "l_fg_offset", "l_locals_transl", "l_locals_rot",
                    "l_recon", "l_dtl_locals_feat"):
            assert t["tb"][key] == 0.0, key
    # the gt box outside the range is zeroed before the dense head
    gt = t["gt_boxes"]
    assert not gt[:, 5].any() and gt[:, 0].any()


GROUPS = ("vfe", "backbone_2d", "corrector", "dense_head")


def _hold_grads(got, want, names, zero, top, tol, what):
    for name in names:
        g, w = got[name], want[name]
        assert g.shape == w.shape, name
        if name in zero:
            assert g.abs().max().item() <= 1e-6 * top and w.abs().max().item() <= 1e-6 * top, name
            continue
        err = (g - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (what, name, err, w.abs().max().item())


@pytest.mark.parametrize("group", GROUPS)
def test_parameter_gradients_match(car_step, group):
    """Every leaf of the whole model against JAX within 1e-2 of its largest
    |g|."""
    want, got = car_step["jax"]["grads"], car_step["torch"]["grads"]
    zero = exact_zero_leaves(car_step["torch"]["model"])
    top = max(v.abs().max().item() for v in want.values())
    names = [n for n in want if n.startswith(group + ".")]
    assert names and set(names) == {n for n in got if n.startswith(group + ".")}
    _hold_grads(got, want, names, zero, top, 1e-2, "port vs JAX")
    if group == "corrector" and not car_step["no_fg"]:
        assert all(want[n].abs().max() > 0 for n in names if ".object_head." in n and n not in zero)


def test_corrector_gradients_on_the_same_bev(car_step):
    """The corrector alone, fed the JAX backbone's BEV and the JAX head's
    cotangent on its output: every leaf against eager ``jax.grad`` within
    1e-4 of its largest |g|."""
    want, got = car_step["jax"]["grads"], car_step["corrector"]
    names = [n for n in want if n.startswith("corrector.")]
    zero = exact_zero_leaves(car_step["torch"]["model"])
    top = max(v.abs().max().item() for v in want.values())
    assert set(got) <= set(names)
    missing = set(names) - set(got)  # leaves no loss reaches without foreground
    assert not missing or car_step["no_fg"]
    for name in missing:
        assert not want[name].any(), name
    _hold_grads(got, want, sorted(got), zero, top, 1e-4, "corrector vs JAX")


@pytest.mark.parametrize("group", GROUPS)
def test_running_statistics_match(car_step, group):
    want, got = car_step["jax"]["state"], car_step["torch"]["state"]
    names = [n for n in got if n.startswith(group + ".") and ".running_" in n]
    assert names
    for name in names:
        torch.testing.assert_close(got[name], want[name], atol=1e-6, rtol=0, msg=name)


def test_device_batch_ships_the_senders_keys():
    """The trainer's batch conversion carries ``instances_tf`` and a teacher
    BEV where the loader gives them, as float32, and leaves host-only keys
    behind."""
    from pcp_tpu_torch.train.train_utils import _to_device_batch

    rng = np.random.default_rng(3)
    batch = {"points": rng.standard_normal((2, 16, 7)), "points_mask": rng.uniform(size=(2, 16)) < 0.9,
             "gt_boxes": rng.standard_normal((2, 4, 8)),
             "instances_tf": rng.standard_normal((2, 3, 11, 4, 4)),
             "teacher_spatial_features_2d": rng.standard_normal((2, 5, 4, 4)),
             "metadata": [{}, {}], "batch_size": 2}
    dev = _to_device_batch(batch, "cpu")
    assert set(dev) == {"points", "points_mask", "gt_boxes", "instances_tf",
                        "teacher_spatial_features_2d"}
    assert dev["points_mask"].dtype == torch.bool
    for key in ("points", "gt_boxes", "instances_tf", "teacher_spatial_features_2d"):
        assert dev[key].dtype == torch.float32
        np.testing.assert_array_equal(dev[key].numpy(), batch[key].astype(np.float32))
    ego = _to_device_batch({k: batch[k] for k in ("points", "points_mask", "gt_boxes")}, "cpu")
    assert set(ego) == {"points", "points_mask", "gt_boxes"}
