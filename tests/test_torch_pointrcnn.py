"""The port's PointRCNN against the JAX package's, at a tiny size (the JAX
tests' NPOINTS [64, 16] and [16, 8, -1], narrow widths, three classes).

* FPS, ball query and three-NN indices exactly (with padding rows);
  grouping and interpolation within 1e-6;
* ``roipoint_pool3d`` on ``tests/test_pointrcnn.py``'s cases and a random
  one: exactly;
* the point head's targets exactly, its losses within 1e-5;
* ``sample_rois_for_rcnn`` with the JAX package's priorities handed in (its
  ``jax.random.uniform`` draws for the foreground, hard and easy groups):
  the same ROIs and slots; the ROI head's losses with foreground ROIs within
  1e-6;
* the detector through the weight bridge: the eval forward's point
  features, proposals (the same NMS indices) and final boxes within 1e-4
  under the margin rule; one training step in float64 (``jax.enable_x64``,
  the same priorities), on the first stage's proposals and on ROIs handed
  in (jittered gt boxes, whose foreground trains the reg and corner
  losses): the loss and its terms within 1e-6 relative, every leaf's
  gradient within 1e-4 of its largest |g|, the running statistics within
  1e-6.

The JAX side is jitted, as the JAX package trains and serves: the port's
PointNet++ ops round as XLA's fused code on the CPU does (its eager op by op
run rounds the squared norms otherwise, and a point that coincides with a
centroid then gets another rounding residue, whose square root weighs in
the interpolation). The JAX PointRCNN builds its point coder with a
``float()`` of a ``jnp.asarray``, which a jit trace refuses; it is traced
under ``jax.ensure_compile_time_eval``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcp_tpu.models.roi_heads.pointrcnn_head as jax_pointrcnn_head
from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.dense_heads.point_head import PointHeadBox as JaxPointHeadBox
from pcp_tpu.models.dense_heads.point_head import enlarge_box3d
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.models.roi_heads.roi_head_template import RoIHeadTemplate as JaxRoIHeadTemplate
from pcp_tpu.models.roi_heads.roi_head_template import assign_targets as jax_assign_targets
from pcp_tpu.models.roi_heads.roi_head_template import sample_rois_for_rcnn as jax_sample_rois
from pcp_tpu.ops import pointnet2 as jax_pn2
from pcp_tpu.ops.roipoint_pool3d import roipoint_pool3d as jax_pool
from pcp_tpu_torch.config import CfgDict
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.models.roi_heads.roi_head_template import (RoIHeadTemplate, assign_targets,
                                                              sample_rois_for_rcnn)
from pcp_tpu_torch.ops import pointnet2 as pn2
from pcp_tpu_torch.ops.roipoint_pool3d import roipoint_pool3d
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from test_pointrcnn import POINTRCNN_CFG, SAMPLER_CFG
from torch_port_helpers import randomize_batch_stats

CLASSES = ("Car", "Pedestrian", "Cyclist")
MEAN_SIZE = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
CFG = copy.deepcopy(POINTRCNN_CFG)
CFG["POINT_HEAD"]["TARGET_CONFIG"]["BOX_CODER_CONFIG"]["mean_size"] = MEAN_SIZE
INFO = dict(class_names=CLASSES, num_point_features=4, point_cloud_range=(-10, -10, -3, 10, 10, 1),
            voxel_size=(0.2, 0.2, 4.0), grid_size=(100, 100, 1))
B, N = 2, 256


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cloud(rng, b=B, n=N, spread=8.0):
    pts = rng.uniform(-spread, spread, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 0, (b, n))
    return pts


def _batch(rng):
    pts = np.concatenate([_cloud(rng), rng.uniform(0, 1, (B, N, 1)).astype(np.float32)], -1)
    gt = np.zeros((B, 5, 8), np.float32)
    gt[:, 0] = [0, 0, -1, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [4, 3, -1, 3.9, 1.6, 1.56, -0.5, 1]
    gt[:, 2] = [-4, -3, -1.1, 0.8, 0.6, 1.73, 1.0, 2]
    gt[0, 3] = [-3, 5, -1.1, 1.76, 0.6, 1.73, -2.0, 3]
    for b in range(B):  # points on the objects
        for k in range(4 if b == 0 else 3):
            box = gt[b, k]
            local = rng.uniform(-0.45, 0.45, (12, 3)) * box[3:6]
            c, s = np.cos(box[6]), np.sin(box[6])
            pts[b, 12 * k:12 * k + 12, :3] = box[:3] + np.stack(
                [c * local[:, 0] - s * local[:, 1], s * local[:, 0] + c * local[:, 1], local[:, 2]], 1)
    return pts, gt


def _fill_params(tree, rng):
    """Seeded weights for a flax params tree of shapes: kernels of fan-in
    scale, BN scales about 1, biases small."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _fill_params(v, rng)
        elif k == "kernel":
            out[k] = (rng.normal(size=v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return out


def jax_priorities(key, b, p):
    """The JAX package's ROI sampling draws (B, 3, P) from the head's key."""
    return np.stack([np.stack([np.asarray(jax.random.uniform(k, (p,)))
                               for k in jax.random.split(kb, 3)])
                     for kb in jax.random.split(jnp.asarray(key), b)])


@pytest.fixture(scope="module")
def pair():
    """Both detectors on the same weights: the JAX package's eval forward and
    its float64 training step (value and gradient), with the head's sampling
    key recorded."""
    rng = np.random.default_rng(0)
    pts, gt = _batch(rng)
    jm = build_jax(JaxCfg(CFG), num_class=3, dataset_info=JaxInfo(**INFO))
    jb = {"points": jnp.asarray(pts), "points_mask": jnp.ones((B, N), bool),
          "gt_boxes": jnp.asarray(gt)}

    def init(batch):
        with jax.ensure_compile_time_eval():
            return jm.init(jax.random.PRNGKey(0), dict(batch, batch_size=B), train=False)

    shapes = jax.eval_shape(init, jb)
    variables = {"params": _fill_params(shapes["params"], rng),
                 "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}
    tm = build_network(CfgDict(CFG), num_class=3, dataset_info=DatasetInfo(**INFO), device="cpu")
    tm.load_state_dict(state_dict_from_jax_variables(variables, CFG), strict=True)
    def apply_eval(v, batch):
        with jax.ensure_compile_time_eval():
            return jm.apply(v, dict(batch, batch_size=B), train=False)

    jeval = _np(jax.jit(apply_eval)(variables, jb))

    jtrain, priorities = _jax_train_step(jm, variables, pts, gt)
    return {"pts": pts, "gt": gt, "variables": variables, "model": tm, "jeval": jeval,
            "jm": jm, "steps": {"proposals": (None, jtrain, priorities)}}


def _given_rois(rng, gt):
    """ROIs handed in with the batch (``proposal_layer`` then passes them
    on, in both packages): each sample's first three gt boxes, six jittered
    copies each, so that the sampled ROIs hold foreground that trains the
    reg tower."""
    g = gt[:, :3]
    rois = np.repeat(g[..., :7], 6, 1) + rng.normal(0, 0.15, (B, 18, 7)).astype(np.float32)
    rois[..., 3:6] = np.abs(rois[..., 3:6])
    return {"rois": rois.astype(np.float32),
            "roi_scores": rng.uniform(0, 1, (B, 18)).astype(np.float32),
            "roi_labels": np.repeat(g[..., 7], 6, 1).astype(np.int32)}


def _jax_train_step(jm, variables, pts, gt, rois=None):
    """The JAX package's float64 training step (value and gradient), its
    sampling key recorded and turned into the port's priorities."""
    keys, orig = [], jax_pointrcnn_head.assign_targets

    def record(key, *args, **kwargs):
        keys.append(np.asarray(key))
        return orig(key, *args, **kwargs)

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        v64 = f64(variables)
        jb64 = {"points": jnp.asarray(pts, jnp.float64), "points_mask": jnp.ones((B, N), bool),
                "gt_boxes": jnp.asarray(gt, jnp.float64)}
        if rois is not None:
            jb64.update(rois=jnp.asarray(rois["rois"], jnp.float64),
                        roi_scores=jnp.asarray(rois["roi_scores"], jnp.float64),
                        roi_labels=jnp.asarray(rois["roi_labels"]))

        def loss_fn(params, batch):
            with jax.ensure_compile_time_eval():
                out, upd = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                    dict(batch, batch_size=B), train=True, mutable=["batch_stats"],
                                    rngs={"sampling": jax.random.PRNGKey(7)})
            return out["loss"], (out["tb_dict"], upd["batch_stats"])

        jax_pointrcnn_head.assign_targets = record
        try:
            (loss, (tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                v64["params"], jb64)
        finally:
            jax_pointrcnn_head.assign_targets = orig
        p = (CFG["ROI_HEAD"]["NMS_CONFIG"]["TRAIN"]["NMS_POST_MAXSIZE"] if rois is None
             else rois["rois"].shape[1])
        priorities = jax_priorities(keys[0], B, p)
    jtrain = {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
              "grads": _np(grads), "stats": _np(stats)}
    return jtrain, priorities


@pytest.fixture(scope="module")
def step(pair, request):
    """The JAX float64 step of ``request.param``: on the first stage's
    proposals, or on ROIs handed in (jittered gt boxes)."""
    if request.param not in pair["steps"]:
        rois = _given_rois(np.random.default_rng(5), pair["gt"])
        pair["steps"][request.param] = (rois,) + _jax_train_step(
            pair["jm"], pair["variables"], pair["pts"], pair["gt"], rois)
    return pair["steps"][request.param]


@pytest.mark.parametrize("padded", [False, True])
def test_pointnet2_ops_match_jax(padded):
    rng = np.random.default_rng(int(padded))
    xyz = _cloud(rng)
    xyz[:, :20] = xyz[:, 20:40]  # coincident points: ties in FPS and in three_nn
    mask = np.ones((B, N), bool)
    if padded:
        mask[1, -60:] = False
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    jidx = np.asarray(jax.jit(jax_pn2.farthest_point_sample, static_argnums=1)(
        jnp.asarray(xyz), 64, jmask))
    tidx = pn2.farthest_point_sample(torch.from_numpy(xyz), 64, tmask)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    new = xyz[np.arange(B)[:, None], jidx]
    for radius, nsample in ((0.5, 8), (1.5, 16), (4.0, 16)):
        ji, je = jax.jit(jax_pn2.ball_query, static_argnums=(0, 1))(
            radius, nsample, jnp.asarray(xyz), jnp.asarray(new), mask=jmask)
        ti, te = pn2.ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new),
                                mask=tmask)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    feats = rng.normal(size=(B, N, 5)).astype(np.float32)
    np.testing.assert_allclose(pn2.group_points(torch.from_numpy(feats), ti).numpy(),
                               np.asarray(jax_pn2.group_points(jnp.asarray(feats), ji)), atol=1e-6)
    known_mask = mask[:, :64]
    jd, jn = jax.jit(jax_pn2.three_nn)(jnp.asarray(xyz), jnp.asarray(new), jnp.asarray(known_mask))
    td, tn = pn2.three_nn(torch.from_numpy(xyz), torch.from_numpy(new), torch.from_numpy(known_mask))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    valid = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), valid)
    np.testing.assert_allclose(td.numpy()[valid], np.asarray(jd)[valid], atol=1e-6, rtol=0)
    w = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
    kf = rng.normal(size=(B, 64, 7)).astype(np.float32)
    np.testing.assert_allclose(
        pn2.three_interpolate(torch.from_numpy(kf), tn, torch.from_numpy(w)).numpy(),
        np.asarray(jax.jit(jax_pn2.three_interpolate)(jnp.asarray(kf), jn, jnp.asarray(w))), atol=1e-6)


def _pool_cases():
    pts = np.zeros((1, 10, 3), np.float32)
    pts[0, :, 0] = np.arange(10)
    rng = np.random.default_rng(5)
    cloud = _cloud(rng, 2, 300, spread=6.0)
    rois = np.concatenate([rng.uniform(-5, 5, (2, 6, 3)), rng.uniform(1, 4, (2, 6, 3)),
                           rng.uniform(-3, 3, (2, 6, 1))], -1).astype(np.float32)
    mask = np.ones((2, 300), bool)
    mask[1, 200:] = False
    return {
        "first_k_and_wrap": (pts, np.arange(10, dtype=np.float32).reshape(1, 10, 1),
                             np.array([[[2.0, 0, 0, 3.0, 2.0, 2.0, 0.0]]], np.float32), 6, (0, 0, 0), None),
        "empty_roi": (np.random.default_rng(0).uniform(-1, 1, (1, 20, 3)).astype(np.float32),
                      np.ones((1, 20, 2), np.float32),
                      np.array([[[50.0, 50, 50, 1, 1, 1, 0.3]]], np.float32), 4, (0, 0, 0), None),
        "extra_width": (np.array([[[1.4, 0, 0]]], np.float32), np.zeros((1, 1, 1), np.float32),
                        np.array([[[0.0, 0, 0, 2.0, 2.0, 2.0, 0.0]]], np.float32), 2, (1.0, 1.0, 1.0), None),
        "random_masked": (cloud, rng.normal(size=(2, 300, 4)).astype(np.float32), rois, 16,
                          (0.2, 0.2, 0.2), mask),
    }


@pytest.mark.parametrize("case", list(_pool_cases()))
def test_roipoint_pool3d_matches_jax(case):
    pts, feats, rois, s, extra, mask = _pool_cases()[case]
    pool = jax.jit(lambda p, f, r, m: jax_pool(p, f, r, s, extra, m))
    jp, je = pool(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(rois),
                  None if mask is None else jnp.asarray(mask))
    tp, te = roipoint_pool3d(torch.from_numpy(pts), torch.from_numpy(feats), torch.from_numpy(rois),
                             s, extra, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_point_head_targets_and_losses_match_jax(pair):
    rng = np.random.default_rng(3)
    pts, gt = pair["pts"], pair["gt"]
    feats = rng.normal(size=(B, N, 16)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -30:] = False
    jhead = JaxPointHeadBox(model_cfg=JaxCfg(CFG["POINT_HEAD"]), num_class=3, input_channels=16)
    jb = {"point_features": jnp.asarray(feats), "point_coords": jnp.asarray(pts[..., :3]),
          "point_coords_mask": jnp.asarray(mask), "gt_boxes": jnp.asarray(gt)}

    def run(batch):
        with jax.ensure_compile_time_eval():
            v = jhead.init(jax.random.PRNGKey(1), batch, train=False)
            out, _ = jhead.apply(v, batch, train=True, mutable=["batch_stats"])
            extend = enlarge_box3d(batch["gt_boxes"], [0.2, 0.2, 0.2])
            targets = jhead.apply(v, batch["point_coords"], batch["point_coords_mask"],
                                  batch["gt_boxes"], extend_gt_boxes=extend, ret_box_labels=True,
                                  box_coder=jhead.box_coder,
                                  method=JaxPointHeadBox.assign_stack_targets)
        return v, out, targets

    jv, jout, jt = _np(jax.jit(run)(jb))
    thead = copy.deepcopy(pair["model"].point_head)
    sd = {k[len("point_head."):]: v for k, v in state_dict_from_jax_variables(
        {name: {"point_head": tree} for name, tree in jv.items()},
        {"POINT_HEAD": CFG["POINT_HEAD"]}).items()}
    thead.load_state_dict(sd, strict=True)
    labels, box_labels = thead.assign_targets(torch.from_numpy(pts[..., :3]),
                                              torch.from_numpy(mask), torch.from_numpy(gt))
    np.testing.assert_array_equal(labels.numpy(), jt["point_cls_labels"])
    assert (labels > 0).sum() >= 30 and (labels == -1).sum() > 0 and set(labels.unique().tolist()) >= {1, 2, 3}
    np.testing.assert_allclose(box_labels.numpy(), jt["point_box_labels"], atol=1e-6)
    tout = thead.train()({k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()})
    assert tout["point_head_loss"].item() == pytest.approx(float(jout["point_head_loss"]), rel=1e-5)
    for k, v in jout["point_head_tb"].items():
        assert tout["point_head_tb"][k].item() == pytest.approx(float(v), rel=1e-5), k
    np.testing.assert_allclose(tout["point_cls_scores"].detach().numpy(),
                               np.asarray(jout["point_cls_scores"]), atol=1e-6)


def _sampling_cases():
    gt = np.zeros((3, 8), np.float32)
    gt[0] = [0, 0, 0, 4, 2, 1.6, 0, 1]
    rois = np.zeros((30, 7), np.float32)
    rois[0] = [0.1, 0, 0, 4, 2, 1.6, 0]
    rois[1] = [0.05, 0.05, 0, 4, 2, 1.6, 0]
    rois[2] = [1.5, 0.8, 0, 4, 2, 1.6, 0.4]
    gt2 = np.zeros((2, 8), np.float32)
    gt2[0] = [20, 20, 0, 4, 2, 1.6, 0, 1]
    rois2 = np.random.default_rng(1).uniform(-5, 5, (20, 7)).astype(np.float32)
    rois2[:, 3:6] = 2.0
    rng = np.random.default_rng(8)
    gt3 = np.zeros((4, 8), np.float32)
    gt3[:3] = np.concatenate([rng.uniform(-5, 5, (3, 3)), np.tile([[3.9, 1.6, 1.56]], (3, 1)),
                              rng.uniform(-3, 3, (3, 1)), [[1], [2], [1]]], 1)
    rois3 = np.repeat(gt3[:3, :7], 20, 0) + rng.normal(0, 0.4, (60, 7)).astype(np.float32)
    rois3[:, 3:6] = np.abs(rois3[:, 3:6])
    return {"fg_bg_mix": (rois, gt, np.ones(30, np.int32)),
            "no_fg_all_bg": (rois2, gt2, np.ones(20, np.int32)),
            "by_class": (rois3.astype(np.float32), gt3, np.repeat([1, 2, 1], 20).astype(np.int32))}


@pytest.mark.parametrize("case", list(_sampling_cases()))
def test_sample_rois_matches_jax_with_its_priorities(case):
    rois, gt, labels = _sampling_cases()[case]
    key = jax.random.PRNGKey(0)
    by_class = case == "by_class"
    sample = jax.jit(lambda *a: jax_sample_rois(*a, SAMPLER_CFG, by_class))
    want = _np(sample(key, jnp.asarray(rois), jnp.ones(len(rois)), jnp.asarray(labels),
                      jnp.asarray(gt)))
    pri = np.stack([np.asarray(jax.random.uniform(k, (len(rois),))) for k in jax.random.split(key, 3)])
    got = sample_rois_for_rcnn(torch.from_numpy(pri), torch.from_numpy(rois),
                               torch.ones(len(rois)), torch.from_numpy(labels).long(),
                               torch.from_numpy(gt), SAMPLER_CFG, by_class)
    for k in ("roi_sel", "roi_sample_valid", "roi_labels"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("rois", "roi_scores", "roi_ious", "gt_of_rois"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6, err_msg=k)
    if case == "fg_bg_mix":
        assert (got["roi_ious"] >= 0.55).sum() == 2


def _loss_inputs(rng):
    """ROIs about gt boxes (most foreground) and head outputs."""
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, :3] = np.concatenate([rng.uniform(-5, 5, (B, 3, 3)), np.tile([3.9, 1.6, 1.56], (B, 3, 1)),
                                rng.uniform(-3, 3, (B, 3, 1)), np.ones((B, 3, 1))], -1)
    rois = np.repeat(gt[:, :3, :7], 6, 1) + rng.normal(0, 0.15, (B, 18, 7)).astype(np.float32)
    return {"rois": rois.astype(np.float32), "roi_scores": rng.uniform(0, 1, (B, 18)).astype(np.float32),
            "roi_labels": np.ones((B, 18), np.int32), "gt_boxes": gt}


def test_roi_targets_and_losses_with_foreground_match_jax():
    rng = np.random.default_rng(4)
    batch = _loss_inputs(rng)
    cfg = dict(SAMPLER_CFG, ROI_PER_IMAGE=12)
    key = jax.random.PRNGKey(3)
    jt = jax.jit(lambda k, b: jax_assign_targets(k, b, cfg, True))(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    tt = assign_targets(torch.from_numpy(jax_priorities(key, B, 18)),
                        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, True)
    for k in ("roi_sel", "reg_valid_mask", "rcnn_cls_labels"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]), err_msg=k)
    np.testing.assert_allclose(tt["gt_of_rois"].numpy(), np.asarray(jt["gt_of_rois"]), atol=2e-6)
    assert tt["reg_valid_mask"].sum() >= 6
    rcnn_cls = rng.normal(size=(B, 12, 1)).astype(np.float32)
    rcnn_reg = rng.normal(0, 0.2, (B, 12, 7)).astype(np.float32)
    roi_cfg = CFG["ROI_HEAD"]
    jhead = JaxRoIHeadTemplate(model_cfg=JaxCfg(roi_cfg), num_class=1)
    want_loss, want_tb = jax.jit(jhead.get_loss)(
        dict(jt, rcnn_cls=jnp.asarray(rcnn_cls), rcnn_reg=jnp.asarray(rcnn_reg)))
    got_loss, got_tb = RoIHeadTemplate(CfgDict(roi_cfg), 1).get_loss(
        dict(tt, rcnn_cls=torch.from_numpy(rcnn_cls), rcnn_reg=torch.from_numpy(rcnn_reg)))
    assert got_loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    for k, v in want_tb.items():
        assert got_tb[k].item() == pytest.approx(float(v), rel=1e-6, abs=1e-7), k
    assert got_tb["rcnn_loss_corner"].item() > 0 and got_tb["rcnn_loss_reg"].item() > 0
    jboxes = np.asarray(jax.jit(lambda r, g: jhead.generate_predicted_boxes(r, None, g)[1])(
        jnp.asarray(batch["rois"][:, :12]), jnp.asarray(rcnn_reg)))
    tboxes = RoIHeadTemplate(CfgDict(roi_cfg), 1).generate_predicted_boxes(
        torch.from_numpy(batch["rois"][:, :12]), torch.from_numpy(rcnn_reg))
    np.testing.assert_allclose(tboxes.numpy(), jboxes, atol=2e-6)


def test_eval_forward_matches_jax(pair):
    jout = pair["jeval"]
    with torch.no_grad():
        tout = pair["model"]({"points": torch.from_numpy(pair["pts"]),
                              "points_mask": torch.ones((B, N), dtype=torch.bool)})
    for k, atol in (("point_features", 1e-5), ("point_cls_preds", 1e-5), ("rois", 1e-4),
                    ("batch_cls_preds", 1e-5), ("batch_box_preds", 1e-4)):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], atol=atol, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tout["roi_labels"].numpy(), jout["roi_labels"])
    np.testing.assert_array_equal(tout["roi_valid"].numpy(), jout["roi_valid"])
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = jout["final_box_dicts"]
    np.testing.assert_array_equal(got["pred_labels"][got["pred_valid"]],
                                  want["pred_labels"][want["pred_valid"]])
    pp = CFG["POST_PROCESSING"]
    compared = 0
    for b in range(B):
        compared += match_surviving_boxes(
            {k: v[b] for k, v in got.items()}, {k: v[b] for k, v in want.items()},
            heat_scores=np.zeros(0), top_k=1, score_thresh=pp["SCORE_THRESH"],
            post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"], margin=1e-4, box_atol=1e-4,
            box_rtol=0, score_atol=1e-5, min_matched=1)
    assert compared >= 4


def _torch_step(model, pts, gt, priorities, dtype, rois=None):
    """The port's training step; returns its output, the model, and the
    targets its ROI head drew."""
    from pcp_tpu_torch.models.roi_heads import pointrcnn_head

    model = copy.deepcopy(model).to(dtype).train()
    batch = {"points": torch.from_numpy(pts).to(dtype), "gt_boxes": torch.from_numpy(gt).to(dtype),
             "points_mask": torch.ones((B, N), dtype=torch.bool),
             "roi_sampling_priorities": torch.from_numpy(priorities).to(dtype)}
    if rois is not None:
        batch.update(rois=torch.from_numpy(rois["rois"]).to(dtype),
                     roi_scores=torch.from_numpy(rois["roi_scores"]).to(dtype),
                     roi_labels=torch.from_numpy(rois["roi_labels"]).long())
    drawn, orig = [], pointrcnn_head.assign_targets
    pointrcnn_head.assign_targets = lambda *a, **k: drawn.append(orig(*a, **k)) or drawn[-1]
    try:
        out = model(batch)
    finally:
        pointrcnn_head.assign_targets = orig
    out["loss"].backward()
    return out, model, drawn[0]


@pytest.mark.parametrize("step", ["proposals", "given_rois"], indirect=True)
def test_train_step_matches_jax_in_float64(pair, step):
    rois, jtrain, priorities = step
    out, model, targets = _torch_step(pair["model"], pair["pts"], pair["gt"], priorities,
                                      torch.float64, rois)
    assert out["loss"].item() == pytest.approx(jtrain["loss"], rel=1e-6)
    assert set(out["tb_dict"]) == set(jtrain["tb"])
    for k, v in jtrain["tb"].items():
        assert out["tb_dict"][k].item() == pytest.approx(v, rel=1e-6, abs=1e-9), k
    want = tensors_from_jax_params(jtrain["grads"], CFG)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    silent = {n for n, w in want.items() if not w.abs().max().item()}
    if rois is None:
        # no proposal of the random weights reaches REG_FG_THRESH: the reg
        # tower takes no gradient in either package
        assert silent == {n for n in want if n.startswith("roi_head.reg_layers.")}, silent
    else:
        # jittered gt boxes: foreground ROIs train the reg and corner losses
        assert int(targets["reg_valid_mask"].sum()) >= 4
        assert jtrain["tb"]["rcnn_loss_reg"] > 0 and jtrain["tb"]["rcnn_loss_corner"] > 0
        assert not silent, silent
    for name, g in got.items():
        w = want[name].double()
        top = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-4 * top, (name, (g - w).abs().max().item(), top)
    state = state_dict_from_jax_variables({"params": pair["variables"]["params"],
                                           "batch_stats": jtrain["stats"]}, CFG)
    for name, v in model.state_dict().items():
        if ".running_" in name:
            torch.testing.assert_close(v, state[name].double(), atol=1e-6, rtol=0, msg=name)


def test_train_step_in_float32_matches_the_float64_loss(pair):
    _, jtrain, priorities = pair["steps"]["proposals"]
    out, model, _ = _torch_step(pair["model"], pair["pts"], pair["gt"],
                                priorities.astype(np.float32), torch.float32)
    assert out["loss"].item() == pytest.approx(jtrain["loss"], rel=1e-4)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
