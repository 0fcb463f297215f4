"""The nuScenes "pointpillar_jr" family of the port against the JAX package.

* ``SCConvBackbone2dStride{1,4}`` on a 40x56 grid (40 is not a multiple of
  16, so the SCConv's 4x pooling floors and its nearest upsampling takes
  half-pixel centres at a scale that is not an integer): eval output within
  atol 1e-5, training output within atol 1e-4 (a BN normalises by the batch
  statistics of a small map) and running statistics within 1e-6.
* ``CenterHead``'s ``vel`` and ``iou`` branches on six heads of the ten
  classes: targets (indices and masks exactly, heatmaps within 1e-6 as
  ``test_torch_targets.py`` holds them, the 11 target columns within 1e-5, among them the velocity and the IoU calibration target), the
  loss and its terms (rel 1e-5), and the decode with ``CALIB_CLS_SCORE`` off
  and on (9-column boxes, the surviving boxes of each head matched under
  the margin rule). Gt boxes without velocity give 9 target columns in both
  packages, whose loss against the 11 predicted ones fails in both.
* Each of the four JR configs (``pointpillar_jr_nomap``, ``_withmap``,
  ``_corr_withmap``, ``oracle_pointpillar_jr_withmap``) at reduced widths on
  an 80x80 grid, the JAX package's weights bridged into the port: the eval
  forward (the BEV within 1e-5, every head branch within atol 1e-4, the
  boxes under the margin rule), then one training step in float64 in both
  packages (``jax.enable_x64``; the same float32 weights and points): the
  loss (rel 1e-6; seen 1.2e-7) and its terms (rel 1e-5), every parameter's
  gradient (each leaf within 1e-4 of its largest |g|; seen 1.8e-6; conv
  biases in front of a BN, 0 in exact arithmetic, within 1e-9 of the
  model's largest |g|) and the running statistics (atol 1e-6); and the
  port's float32 step against it: the loss (rel 1e-4) and the statistics
  (atol 1e-5). In float32 a ReLU input within rounding of 0 passes the
  gradient in one package and not in the other, and a BN over a small map
  conditions its gradient badly: one such flip in a ``vel`` or ``iou``
  tower (a handful of gt cells carry its loss) moved a leaf's float32
  gradient by 14%, and the SCConv backbone's float32 gradients of the JAX
  package lie up to 1e-2 from the float64 ones, where the port's lie within
  1e-5 (both packages' float64 gradients agree to 3e-14 on the backbone
  alone). In float64 the JAX package's jitted VFE gradient equals its eager
  one, so the step is taken jitted whole.
* The distillation teacher of ``pointpillar_jr_corr_withmap_teacher`` with
  its SCConv backbone: its BEV within 1e-5 of the JAX module's, and the
  config's training step failing in both packages (the JAX corrector is 64
  channels wide behind an SCConv backbone, the teacher's BEV 384: ROADMAP C).

The JAX parameters come from ``jax.eval_shape`` of the init, filled with
numpy (a fan-in scaled normal for kernels), so that no init is compiled.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import ROOT_DIR
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.backbones_2d import sc_conv_backbone as jsc
from pcp_tpu.models.bev_layers.teacher import Teacher as JaxTeacher
from pcp_tpu.models.dense_heads.center_head import CenterHead as JaxHead
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.models.vfe.dynamic_pillar_vfe import DynamicPillarVFE as JaxVFE
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.models.backbones_2d import sc_conv_backbone as tsc
from pcp_tpu_torch.models.dense_heads.center_head import CenterHead
from pcp_tpu_torch.train.train_state import biases_before_bn
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import (_head, _sc_backbone, state_dict_from_jax_variables,
                                             tensors_from_jax_params)
from torch_port_helpers import load_eval_variables, randomize_batch_stats

CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer', 'barrier', 'motorcycle',
           'bicycle', 'pedestrian', 'traffic_cone')
PC = (-8.0, -8.0, -5.0, 8.0, 8.0, 3.0)
VOXEL = (0.2, 0.2, 8.0)
GRID = (80, 80, 1)
CONFIGS = ("pointpillar_jr_nomap", "pointpillar_jr_withmap", "pointpillar_jr_corr_withmap",
           "oracle_pointpillar_jr_withmap")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_params(shapes, rng, hm_bias=-1.0):
    """Flax parameters of the given shapes, from numpy: kernels normal with
    std 1/sqrt(fan in), BN scales in [0.8, 1.2], biases normal(0, 0.05), the
    heatmap outputs' bias ``hm_bias`` (so that every head has boxes above
    SCORE_THRESH)."""
    def fill(tree, name=""):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: fill(v, k if k not in ("kernel", "bias", "scale") else f"{name}/{k}")
                    for k, v in tree.items()}
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(tree.shape[:-1]))
            return rng.normal(0, 1 / np.sqrt(fan_in), tree.shape).astype(np.float32)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, tree.shape).astype(np.float32)
        if name.startswith("hm_out/"):
            return np.full(tree.shape, hm_bias, np.float32)
        return rng.normal(0, 0.05, tree.shape).astype(np.float32)
    return fill(shapes)


def numpy_variables(module, args, rng, **kwargs):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    return {"params": numpy_params(shapes["params"], rng),
            "batch_stats": randomize_batch_stats(shapes.get("batch_stats", {}), rng)}


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------ SCConv
@pytest.mark.parametrize("stride", [1, 4])
def test_sc_conv_backbone_matches_jax(stride):
    rng = np.random.default_rng(stride)
    name = f"SCConvBackbone2dStride{stride}"
    cfg = {"NAME": name, "NUM_BEV_FEATURES": 24, "STEM_CHANNELS": 12}
    x = rng.normal(size=(2, 40, 56, 8)).astype(np.float32)
    jm = getattr(jsc, name)(model_cfg=cfg, input_channels=8)
    batch = {"spatial_features": jnp.asarray(x)}
    variables = numpy_variables(jm, (batch,), rng)
    tm = getattr(tsc, name)(cfg, 8).eval()
    sd = {}
    _sc_backbone(sd, variables["params"], variables["batch_stats"], "bb")
    tm.load_state_dict({k[3:]: v for k, v in sd.items()}, strict=True)
    tb = {"spatial_features": torch.from_numpy(x).permute(0, 3, 1, 2)}

    want = np.asarray(jax.jit(lambda v: jm.apply(v, batch))(variables)["spatial_features_2d"])
    with torch.no_grad():
        got = nhwc(tm(tb)["spatial_features_2d"])
    assert got.shape == want.shape == (2, 40 // stride, 56 // stride, 24)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    out, upd = jax.jit(lambda v: jm.apply(v, batch, train=True, mutable=["batch_stats"]))(
        variables)
    tm.train()
    got = nhwc(tm(tb)["spatial_features_2d"])
    np.testing.assert_allclose(got, np.asarray(out["spatial_features_2d"]), atol=1e-4, rtol=1e-4)
    sd = {}
    _sc_backbone(sd, variables["params"], _np(upd["batch_stats"]), "bb")
    for k, v in tm.state_dict().items():
        if ".running_" in k:
            torch.testing.assert_close(v, sd[f"bb.{k}"], atol=1e-6, rtol=0, msg=k)


# ------------------------------------------------------------ CenterHead
def _head_cfg(calib=False):
    cfg = jax_cfg_from_yaml(str(ROOT_DIR / "tools/cfgs/nuscenes_models/pointpillar_jr_nomap.yaml"),
                            JaxCfg())
    head = cfg.MODEL.DENSE_HEAD
    head.SHARED_CONV_CHANNEL = 16
    head.POST_PROCESSING.CALIB_CLS_SCORE = calib
    return head


def _gt(rng, b, vel=True):
    gt = np.zeros((b, 500, 10 if vel else 8), np.float32)
    for i in range(b):
        k = 14
        gt[i, :k, 0:2] = rng.uniform(-7.5, 7.5, (k, 2))
        gt[i, :k, 2] = rng.uniform(-2, 0, k)
        gt[i, :k, 3:6] = rng.uniform(0.5, 5.0, (k, 3))
        gt[i, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        if vel:
            gt[i, :k, 7:9] = rng.normal(0, 3, (k, 2))
            gt[i, 1, 7] = np.nan  # a box without a velocity neighbour
        gt[i, :k, -1] = np.arange(k) % 10 + 1
    gt[0, 0, 0] = 8.4  # past the grid: clipped to the last column
    return gt


def _head_pair(calib=False, seed=0):
    rng = np.random.default_rng(seed)
    hcfg = _head_cfg(calib)
    kwargs = dict(model_cfg=hcfg, input_channels=16, num_class=10, class_names=CLASSES,
                  grid_size=GRID, point_cloud_range=PC, voxel_size=VOXEL)
    jm = JaxHead(**kwargs)
    x = rng.normal(size=(2, 20, 20, 16)).astype(np.float32)
    variables = numpy_variables(jm, ({"spatial_features_2d": jnp.asarray(x)},), rng)
    sd = {}
    _head(sd, variables["params"], variables["batch_stats"], hcfg)
    tm = CenterHead(CfgDict(copy.deepcopy(dict(hcfg))), **{k: v for k, v in kwargs.items()
                                                           if k != "model_cfg"})
    tm.load_state_dict({k[len("dense_head."):]: v for k, v in sd.items()}, strict=True)
    return jm, variables, tm.eval(), x, rng


@pytest.fixture(scope="module")
def head_train():
    jm, variables, tm, x, rng = _head_pair()
    gt = _gt(rng, 2)
    jb = {"spatial_features_2d": jnp.asarray(x), "gt_boxes": jnp.asarray(gt)}
    def step(v):
        out, _ = jm.apply(v, jb, train=True, mutable=["batch_stats"])
        return out, jm.apply(v, out["head_preds"], out["head_targets"], method=JaxHead.get_loss)

    jout, (jloss, jtb) = jax.jit(step)(variables)
    tm.train()
    tout = tm({"spatial_features_2d": torch.from_numpy(x).permute(0, 3, 1, 2),
               "gt_boxes": torch.from_numpy(gt)})
    tloss, ttb = tm.get_loss(tout["head_preds"], tout["head_targets"])
    return jout, (float(jloss), {k: float(v) for k, v in jtb.items()}), tout, (tloss, ttb)


def test_head_targets_with_velocity_and_iou_match_jax(head_train):
    jout, _, tout, _ = head_train
    assert len(tout["head_targets"]) == 6
    for jt, tt in zip(jout["head_targets"], tout["head_targets"]):
        np.testing.assert_allclose(tt["heatmap"].numpy(), np.asarray(jt["heatmap"]), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(tt["inds"].numpy(), np.asarray(jt["inds"]))
        np.testing.assert_array_equal(tt["mask"].numpy(), np.asarray(jt["mask"]))
        want = np.asarray(jt["target_boxes"])
        assert tt["target_boxes"].shape == want.shape == (2, 500, 11)
        np.testing.assert_allclose(tt["target_boxes"].numpy(), want, atol=1e-5, rtol=0)
    # the IoU column is 2 IoU - 1 of valid rows, in [-1, 1]; some overlap
    iou = np.concatenate([t["target_boxes"][..., -1][t["mask"]].numpy()
                          for t in tout["head_targets"]])
    assert iou.size and (iou >= -1).all() and (iou <= 1).all() and (iou > -1).any()


def test_head_loss_matches_jax(head_train):
    _, (jloss, jtb), _, (tloss, ttb) = head_train
    assert tloss.item() == pytest.approx(jloss, rel=1e-5)
    assert set(ttb) == set(jtb)
    for k, v in jtb.items():
        assert ttb[k].item() == pytest.approx(v, rel=1e-5), k


def test_targets_without_velocity_fail_the_loss_in_both():
    """Gt boxes of 8 columns (the nuScenes dataset's items) give 9 target
    columns; the 11 predicted columns cannot be held against them, in
    either package (ROADMAP C)."""
    jm, variables, tm, x, rng = _head_pair(seed=1)
    gt = _gt(rng, 2, vel=False)
    jout, _ = jax.jit(lambda v: jm.apply(v, {"spatial_features_2d": jnp.asarray(x),
                                             "gt_boxes": jnp.asarray(gt)}, train=True,
                                         mutable=["batch_stats"]))(variables)
    assert jout["head_targets"][0]["target_boxes"].shape[-1] == 9
    with pytest.raises(TypeError):
        jm.apply(variables, jout["head_preds"], jout["head_targets"], method=JaxHead.get_loss)
    tm.train()
    tout = tm({"spatial_features_2d": torch.from_numpy(x).permute(0, 3, 1, 2),
               "gt_boxes": torch.from_numpy(gt)})
    assert tout["head_targets"][0]["target_boxes"].shape[-1] == 9
    with pytest.raises(RuntimeError):
        tm.get_loss(tout["head_preds"], tout["head_targets"])


def _calibrated_heat(pred, pp):
    heat = 1 / (1 + np.exp(-np.asarray(pred["hm"], np.float64)))
    if pp.get("CALIB_CLS_SCORE", False):
        a = float(pp.get("CALIB_CLS_SCORE_ALPHA", 0.5))
        iou = np.clip((np.asarray(pred["iou"], np.float64) + 1) / 2, 0, 1)
        heat = heat ** (1 - a) * iou ** a
    return heat


def hold_boxes(jout, tout, pp, heads=6):
    """Each head's surviving boxes under the margin rule; returns the
    number matched."""
    post = int(pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"])
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = {k: np.asarray(v) for k, v in jout["final_box_dicts"].items()}
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert got["pred_boxes"].shape[1:] == (heads * post, 9)
    matched = 0
    for h in range(heads):
        heat = _calibrated_heat(jout["head_preds"][h], pp)
        sl = slice(h * post, (h + 1) * post)
        for i in range(got["pred_boxes"].shape[0]):
            matched += match_surviving_boxes(
                {k: v[i, sl] for k, v in got.items()}, {k: v[i, sl] for k, v in want.items()},
                heat[i].reshape(-1), top_k=int(pp["MAX_OBJ_PER_SAMPLE"]),
                score_thresh=float(pp["SCORE_THRESH"]), post_max=post, min_matched=1)
    return matched


@pytest.mark.parametrize("calib", [False, True], ids=["calib_off", "calib_on"])
def test_head_decode_matches_jax(calib):
    jm, variables, tm, x, _ = _head_pair(calib, seed=2)
    jout = jax.jit(lambda v: jm.apply(v, {"spatial_features_2d": jnp.asarray(x)}))(variables)
    with torch.no_grad():
        tout = tm({"spatial_features_2d": torch.from_numpy(x).permute(0, 3, 1, 2)})
    for jp, tp in zip(jout["head_preds"], tout["head_preds"]):
        assert set(tp) == {"hm", "center", "center_z", "dim", "rot", "vel", "iou"}
        for k in tp:
            np.testing.assert_allclose(nhwc(tp[k]), np.asarray(jp[k]), atol=1e-5, rtol=1e-5)
    assert hold_boxes(jout, tout, _head_cfg(calib).POST_PROCESSING) > 100


# ------------------------------------------------------- the four configs
def _configs(name):
    """The config ``name`` at reduced widths, for each package."""
    out = []
    for make, load in ((JaxCfg, jax_cfg_from_yaml), (CfgDict, cfg_from_yaml_file)):
        cfg = load(str(ROOT_DIR / f"tools/cfgs/nuscenes_models/{name}.yaml"), make())
        m = cfg.MODEL
        for sub in (m, m.get("TEACHER")):
            if sub is not None:
                sub.VFE.NUM_FILTERS = [16, 16]
                sub.MAP_TO_BEV.NUM_BEV_FEATURES = 16
                sub.BACKBONE_2D.NUM_BEV_FEATURES = 48
        m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
        if "CORRECTOR" in m:
            m.CORRECTOR.POINT_HEAD_HIDDEN_CHANNELS = [8]
            m.CORRECTOR.OBJ_HEAD_HIDDEN_CHANNELS = [8]
        out.append(cfg)
    return out


def _info(cfg):
    return dict(class_names=CLASSES,
                num_point_features=len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list),
                point_cloud_range=PC, voxel_size=VOXEL, grid_size=GRID)


def jr_points(rng, b, n, nf):
    """Points as ``tests/test_nuscenes_stack.py`` makes them, at this
    grid: every feature uniform over the range, intensity in [0, 1]; a
    padding tail in the second cloud."""
    pts = rng.uniform(-7.9, 7.9, (b, n, nf)).astype(np.float32)
    pts[..., 2] = rng.uniform(-4.5, 2.5, (b, n))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    mask = np.ones((b, n), bool)
    mask[1, -150:] = False
    return pts, mask


def _jax_step(jm, variables, jb, vfe_cfg, info, eager_vfe=True):
    """The JAX training forward and backward: the loss, its terms, the new
    statistics and the gradient. With ``eager_vfe`` the VFE's gradient is
    taken without ``jax.jit`` (module docstring), through the cotangent of
    the BEV, which a zero added to it in the jitted step gives."""
    def run(params, eps):
        bound = jm.bind({"params": params, "batch_stats": variables["batch_stats"]},
                        mutable=["batch_stats"])
        d = dict(jb)
        for module in bound.module_list:
            d = module(d, train=True)
            if "spatial_features" in d and "spatial_features_2d" not in d:
                d = dict(d, spatial_features=d["spatial_features"] + eps)
        loss, tb = bound.module_list[-1].get_loss(d["head_preds"], d["head_targets"])
        return loss, (tb, bound.variables["batch_stats"])

    b, (ny, nx) = jb["points"].shape[0], GRID[1::-1]
    eps = jnp.zeros((b, ny, nx, int(vfe_cfg["NUM_FILTERS"][-1])), jb["points"].dtype)
    (loss, (tb, stats)), (grads, cot) = jax.jit(
        jax.value_and_grad(run, argnums=(0, 1), has_aux=True))(variables["params"], eps)
    grads = _np(grads)
    if eager_vfe:
        jvfe = JaxVFE(model_cfg=vfe_cfg, num_point_features=info["num_point_features"],
                      voxel_size=VOXEL, grid_size=GRID, point_cloud_range=PC)

        def vfe_out(params):
            out, _ = jvfe.apply({"params": params, "batch_stats": variables["batch_stats"]["vfe"]},
                                jb, train=True, mutable=["batch_stats"])
            return jnp.sum(out["pillar_features"] * cot.reshape(b, ny * nx, -1))

        grads["vfe"] = _np(jax.grad(vfe_out)(variables["params"]["vfe"]))
    return {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()}, "stats": _np(stats),
            "grads": grads}


@pytest.fixture(scope="module", params=CONFIGS)
def jr_pair(request):
    """One JR config in both packages: the eval forward and one training
    step of each on the same weights and points."""
    name = request.param
    jcfg, tcfg = _configs(name)
    info = _info(jcfg)
    rng = np.random.default_rng(CONFIGS.index(name))
    jm = build_jax(jcfg.MODEL, num_class=10, dataset_info=JaxInfo(**info))
    pts, mask = jr_points(rng, 2, 1500, info["num_point_features"])
    gt = _gt(rng, 2)
    jb = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask), "batch_size": 2}
    # a training init traces no decode; without instances_tf it never calls
    # HunterJr's object head, whose weights the port keeps (torch_port_helpers)
    variables = numpy_variables(jm, (dict(jb, gt_boxes=jnp.asarray(gt)),), rng, train=True)
    tm = build_network(tcfg.MODEL, num_class=10, dataset_info=DatasetInfo(**info), device="cpu")
    load_eval_variables(tm, variables, jcfg.MODEL)
    tb = {"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)}

    jeval = jax.jit(lambda v: jm.apply(v, jb, train=False))(variables)
    with torch.no_grad():
        teval = tm(tb)
    tb["gt_boxes"] = torch.from_numpy(gt)
    ttrain = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(tm).to(dtype).train()
        out = model({k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()})
        out["loss"].backward()
        ttrain[dtype] = {"loss": out["loss"].item(), "state": model.state_dict(),
                         "tb": {k: v.item() for k, v in out["tb_dict"].items()},
                         "grads": {n: p.grad for n, p in model.named_parameters()}}
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        jb64 = dict(f64({k: v for k, v in jb.items() if k != "points_mask"}),
                    points_mask=jb["points_mask"], batch_size=2,
                    gt_boxes=jnp.asarray(gt, jnp.float64))
        jtrain = _jax_step(jm, f64(variables), jb64, jcfg.MODEL.VFE, info, eager_vfe=False)
    return {"name": name, "cfg": jcfg, "jax": (jeval, jtrain, variables), "torch": (teval, ttrain),
            "model": tm}


def test_jr_forward_matches_jax(jr_pair):
    (jout, _, _), (tout, _) = jr_pair["jax"], jr_pair["torch"]
    np.testing.assert_allclose(nhwc(tout["spatial_features"]), np.asarray(jout["spatial_features"]),
                               atol=1e-5, rtol=1e-5)
    want_bev = np.asarray(jout["spatial_features_2d"])
    assert want_bev.shape[-1] == (16 if "corr" in jr_pair["name"] else 48)  # the corrector's width
    np.testing.assert_allclose(nhwc(tout["spatial_features_2d"]), want_bev, atol=1e-4, rtol=1e-4)
    for jp, tp in zip(jout["head_preds"], tout["head_preds"]):
        for k in jp:
            np.testing.assert_allclose(nhwc(tp[k]), np.asarray(jp[k]), atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    assert hold_boxes(jout, tout, jr_pair["cfg"].MODEL.DENSE_HEAD.POST_PROCESSING) > 100


def test_jr_train_loss_matches_jax(jr_pair):
    (_, jtrain, _), (_, ttrain) = jr_pair["jax"], jr_pair["torch"]
    jtb, t64, t32 = jtrain["tb"], ttrain[torch.float64], ttrain[torch.float32]
    assert set(t64["tb"]) == set(t32["tb"]) == set(jtb)
    assert {f"loc_loss_head_{h}" for h in range(6)} <= set(jtb)
    assert t64["loss"] == pytest.approx(jtrain["loss"], rel=1e-6)
    for k, v in jtb.items():
        assert t64["tb"][k] == pytest.approx(v, rel=1e-5), k
    assert np.isfinite(t32["loss"]) and t32["loss"] == pytest.approx(jtrain["loss"], rel=1e-4)


def test_jr_gradients_and_statistics_match_jax(jr_pair):
    (_, jtrain, variables), (_, ttrain) = jr_pair["jax"], jr_pair["torch"]
    cfg = jr_pair["cfg"].MODEL
    want, got = tensors_from_jax_params(jtrain["grads"], cfg), ttrain[torch.float64]["grads"]
    top = max(v.abs().max().item() for v in want.values())
    before_bn = biases_before_bn(jr_pair["model"])
    # without ``instances_tf`` the corrector's object head and its point head's
    # seg, flow and embedding outputs reach the loss only through discrete
    # decisions: no gradient in the port, zeros in the JAX package
    unused = {n for n, g in got.items() if g is None}
    assert unused <= {n for n in got if n.startswith("corrector.")}, unused
    for name in unused:
        assert name not in want or not want[name].abs().max().item(), name
    got = {n: g for n, g in got.items() if g is not None}
    want = {n: g for n, g in want.items() if n not in unused}
    assert set(want) == set(got)
    for name, g in got.items():
        w = want[name].double()
        assert g.shape == w.shape, name
        if name in before_bn:
            assert g.abs().max().item() <= 1e-9 * top and w.abs().max().item() <= 1e-9 * top, name
            continue
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err, w.abs().max().item())
    state = state_dict_from_jax_variables({"params": variables["params"],
                                           "batch_stats": jtrain["stats"]}, cfg)
    for dtype, atol in ((torch.float64, 1e-6), (torch.float32, 1e-5)):
        for name, v in ttrain[dtype]["state"].items():
            if ".running_" in name and not name.startswith("corrector.object_head."):
                torch.testing.assert_close(v.double(), state[name].double(), atol=atol, rtol=0,
                                           msg=name)


# ------------------------------------------------------- the teacher
def test_teacher_matches_jax_and_its_config_cannot_train():
    jcfg, tcfg = _configs("pointpillar_jr_corr_withmap_teacher")
    info = _info(jcfg)
    rng = np.random.default_rng(9)
    pts, mask = jr_points(rng, 2, 1500, info["num_point_features"])
    jb = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask), "batch_size": 2}
    jt = JaxTeacher(model_cfg=jcfg.MODEL.TEACHER, info=JaxInfo(**info))
    tv = numpy_variables(jt, (jb,), rng, train=True)
    want = np.asarray(jax.jit(lambda v: jt.apply(v, jb, train=True))(tv)[
        "teacher_spatial_features_2d"])
    tm = build_network(tcfg.MODEL, num_class=10, dataset_info=DatasetInfo(**info), device="cpu")
    sd = state_dict_from_jax_variables({"params": {"teacher": tv["params"]},
                                        "batch_stats": {"teacher": tv["batch_stats"]}},
                                       {"TEACHER": jcfg.MODEL.TEACHER})
    assert sd and all(k.startswith("teacher.") for k in sd)
    result = tm.load_state_dict(sd, strict=False)
    assert not result.unexpected_keys and not any(k.startswith("teacher.")
                                                  for k in result.missing_keys)
    tm.train()
    with torch.no_grad():
        got = tm.teacher({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})
    assert got["teacher_spatial_features_2d"].shape[1] == 48
    np.testing.assert_allclose(nhwc(got["teacher_spatial_features_2d"]), want, atol=1e-5,
                               rtol=1e-5)

    gt = _gt(rng, 2)
    jm = build_jax(jcfg.MODEL, num_class=10, dataset_info=JaxInfo(**info))
    with pytest.raises(TypeError):
        jax.eval_shape(lambda k: jm.init(k, dict(jb, gt_boxes=jnp.asarray(gt)), train=True),
                       jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="teacher"):
        tm(dict({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)},
                gt_boxes=torch.from_numpy(gt)))
