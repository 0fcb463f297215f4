"""The port's PV-RCNN against the JAX package's, at a tiny size (the
structure of ``tests/test_pvrcnn.py``'s ``PVRCNN_CFG``, 128 x 128 x 40
voxels, with ``custom_models/pv_rcnn.yaml``'s three-class anchor set, 256
points and 32 keypoints a cloud, the second cloud padded, its first point
masked and fewer valid points than keypoints).

Module by module (f32, TF32 off):
* ``bilinear_interpolate_bev`` (points on and past the border) within 1e-6
  and ``get_voxel_centers_from_ids`` exactly;
* the VSA on seeded ``multi_scale_3d_features``: keypoints and every ball
  query's indices equal, the features within 1e-5 in eval and training, the
  fusion BN's statistics within 1e-6;
* PointHeadSimple: its targets (the ignore flag too) exactly, the loss and
  scores within 1e-5;
* ``get_dense_grid_points`` and the ROI grid points exactly; PVRCNNHead's
  eval forward within 1e-5, and its training losses with the JAX package's
  ROI-sampling priorities handed in within 1e-5;
* the three-class AnchorHeadSingle in training: targets exactly, the loss
  terms within 1e-5 and the boxes it decodes for the proposals within 1e-5.

The whole detector through the weight bridge: the eval forward (keypoints
and the NMS's kept ROIs equal, keypoint features within 1e-5, the refined
and final boxes within 1e-4 under the margin rule); one training step in
float64 on the first stage's proposals and on ROIs handed in (jittered gt
boxes, so that the reg and corner losses train): the loss and its terms
within 1e-6 relative, every leaf's gradient within 1e-4 of its largest |g|,
the running statistics within 1e-6. ``DP_RATIO`` is 0 for these steps: the
two packages' dropout masks come from unrelated generators.

The JAX side is jitted (the port's PointNet++ ops and voxel centres round
as XLA's fused CPU code), a stage of its module list at a time: compiled
whole, the model took about 60 s for the eval forward and 130 s for a
float64 gradient on this CPU, staged about half. The float64 step is
compiled once for both cases:
the JAX proposal layer is wrapped to take the handed-in ROIs where the batch
says so, which gives the JAX package's own given-ROI step (no gradient
reaches the first stage through them). The variables come from
``jax.eval_shape`` of the init, filled from a seed.

PV-RCNN++ (``_ppcfg``'s SPC sampling and VectorPool modules over the same
structure, ``entry.PVRCNN_PLUSPLUS``): ``VectorPoolAggregationModuleMSG``
in both aggregation types (eval and training within 1e-5, statistics
1e-6); the VSA with SPC sampling, whose valid keypoints are the JAX
package's candidates exactly; the whole detector's eval forward and a
float64 step on handed-in ROIs, as PV-RCNN's. The JAX side shares PV-RCNN's
weights and jitted stages up to the anchor head, then runs a JAX PV-RCNN++
built of the PFE, point head and ROI head alone, whose own ``__call__``
draws the proposals (and in training samples the targets) before them.
The train and test CLIs run PV-RCNN++ through ``--set``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcp_tpu.models.roi_heads.pvrcnn_head as jax_pvrcnn_head
from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.models import build_network as build_jax
from pcp_tpu.models.backbones_3d.pfe.voxel_set_abstraction import \
    VoxelSetAbstraction as JaxVSA
from pcp_tpu.models.backbones_3d.vector_pool import \
    VectorPoolAggregationModuleMSG as JaxVectorPoolMSG
from pcp_tpu.models.backbones_3d.vector_pool import \
    local_voxel_offsets as jax_local_voxel_offsets
from pcp_tpu.models.backbones_3d.pfe.voxel_set_abstraction import \
    bilinear_interpolate_bev as jax_bilinear
from pcp_tpu.models.backbones_3d.pfe.voxel_set_abstraction import \
    get_voxel_centers_from_ids as jax_voxel_centers
from pcp_tpu.models.dense_heads.anchor_head_single import AnchorHeadSingle as JaxAnchorHead
from pcp_tpu.models.dense_heads.point_head import PointHeadSimple as JaxPointHeadSimple
from pcp_tpu.models.dense_heads.point_head import enlarge_box3d
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.models.detectors.pointpillar import generic_post_processing
from pcp_tpu.models.roi_heads.pvrcnn_head import PVRCNNHead as JaxPVRCNNHead
from pcp_tpu.models.roi_heads.pvrcnn_head import get_dense_grid_points as jax_dense_grid
from pcp_tpu.models.roi_heads.roi_head_template import rotate_points_along_z_jnp
from pcp_tpu.ops import pointnet2 as jax_pn2
from pcp_tpu_torch.config import CfgDict
from pcp_tpu_torch.entry import CFG_PVRCNN, PVRCNN_PLUSPLUS, PVRCNN_Z_RANGE, build
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.models.backbones_3d import pointnet2_modules
from pcp_tpu_torch.models.backbones_3d.pfe.voxel_set_abstraction import (
    VoxelSetAbstraction, bilinear_interpolate_bev, get_voxel_centers_from_ids, spc_candidates)
from pcp_tpu_torch.models.backbones_3d.vector_pool import (VectorPoolAggregationModuleMSG,
                                                           local_voxel_offsets)
from pcp_tpu_torch.models.dense_heads.anchor_head_single import AnchorHeadSingle
from pcp_tpu_torch.models.dense_heads.point_head import PointHeadSimple
from pcp_tpu_torch.models.roi_heads.pvrcnn_head import PVRCNNHead, get_dense_grid_points
from pcp_tpu_torch.ops import pointnet2 as pn2
from pcp_tpu_torch.utils import jax_weights
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from test_pvrcnn import PVRCNN_CFG
from test_pvrcnn_plusplus import _ppcfg
from torch_port_helpers import randomize_batch_stats

CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
ANCHORS = [{"class_name": name, "anchor_sizes": [size], "anchor_rotations": [0, 1.57],
            "anchor_bottom_heights": [0], "align_center": False, "feature_map_stride": 8,
            "matched_threshold": hi, "unmatched_threshold": lo}
           for name, size, hi, lo in (("Vehicle", [3.9, 1.6, 1.56], 0.55, 0.4),
                                      ("Pedestrian", [0.8, 0.6, 1.73], 0.5, 0.35),
                                      ("Cyclist", [1.76, 0.6, 1.73], 0.5, 0.35))]
CFG = copy.deepcopy(PVRCNN_CFG)
CFG["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = ANCHORS
CFG["PFE"]["NUM_KEYPOINTS"] = 32
CFG["ROI_HEAD"]["DP_RATIO"] = 0.0
INFO = dict(class_names=CLASSES, num_point_features=4,
            point_cloud_range=(-6.4, -6.4, -8.0, 6.4, 6.4, 0.0), voxel_size=(0.1, 0.1, 0.2),
            grid_size=(128, 128, 40))
B, N, K = 2, 256, 32
VALID_1 = 21  # valid rows of the second cloud, its first masked: fewer than K
P_TRAIN = CFG["ROI_HEAD"]["NMS_CONFIG"]["TRAIN"]["NMS_POST_MAXSIZE"]
SAMPLING_KEY = 7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fill_params(tree, rng):
    """Seeded weights for a flax params tree of shapes: kernels normal with
    std 1/sqrt(fan-in) (every axis but the last), BN scales about 1, biases
    small."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _fill_params(v, rng)
        elif k == "kernel":
            out[k] = (rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return out


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _on_box(rng, box, n):
    local = rng.uniform(-0.45, 0.45, (n, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    return box[:3] + np.stack([c * local[:, 0] - s * local[:, 1],
                               s * local[:, 0] + c * local[:, 1], local[:, 2]], 1)


def _batch(rng):
    """Points (B, N, 4), mask (B, N), gt (B, 4, 8): three classes in the
    first cloud, one box in the second, a dozen points on each box."""
    pts = rng.uniform(-6, 6, (B, N, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-4.0, -0.5, (B, N))
    pts[..., 3] = rng.uniform(0, 1, (B, N))
    gt = np.zeros((B, 4, 8), np.float32)
    gt[0, 0] = [0, 0, -2, 3.9, 1.6, 1.56, 0.3, 1]
    gt[0, 1] = [3, -2.5, -2.1, 0.8, 0.6, 1.73, -0.8, 2]
    gt[0, 2] = [-3, 2.5, -2.1, 1.76, 0.6, 1.73, 1.2, 3]
    gt[1, 0] = [2, 2, -2, 3.9, 1.6, 1.56, -0.4, 1]
    for b, count in ((0, 3), (1, 1)):
        for k in range(count):
            start = 1 + 12 * k
            pts[b, start:start + 12, :3] = _on_box(rng, gt[b, k], 12)
    mask = np.ones((B, N), bool)
    mask[1, 0] = False
    mask[1, VALID_1 + 1:] = False
    return pts, mask, gt


def _given_rois(rng, gt):
    """P_TRAIN ROIs a cloud handed in with the batch: jittered copies of its
    gt boxes, then zero rows."""
    rois = np.zeros((B, P_TRAIN, 7), np.float32)
    labels = np.zeros((B, P_TRAIN), np.int32)
    for b in range(B):
        real = gt[b][gt[b, :, 7] > 0]
        reps = np.repeat(real, 8, 0)
        rois[b, :len(reps)] = reps[:, :7] + rng.normal(0, 0.1, (len(reps), 7))
        labels[b, :len(reps)] = reps[:, 7]
    rois[..., 3:6] = np.abs(rois[..., 3:6])
    scores = np.where(labels > 0, rng.uniform(0, 1, labels.shape), 0).astype(np.float32)
    return rois.astype(np.float32), scores, labels


def jax_priorities(key, b, p):
    """The JAX package's ROI sampling draws (B, 3, P) from the head's key,
    for the foreground, hard and easy background groups."""
    return jnp.stack([jnp.stack([jax.random.uniform(k, (p,)) for k in jax.random.split(kb, 3)])
                      for kb in jax.random.split(key, b)])


class recorded_priorities:
    """Within the block, the JAX ``assign_targets`` of ``module`` also puts
    the priorities its sampling key gives (``jax_priorities``) into the
    targets, and so into the head's output as
    ``roi_sampling_priorities_jax``, for the port to be handed."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        self.orig = self.module.assign_targets

        def record(key, batch, *args, **kwargs):
            t = self.orig(key, batch, *args, **kwargs)
            batch["roi_sampling_priorities_jax"] = jax_priorities(key, *batch["rois"].shape[:2])
            return t

        self.module.assign_targets = record
        return self

    def __exit__(self, *exc):
        self.module.assign_targets = self.orig


def _static_split(batch):
    """A batch dict's array leaves, the function that puts them back beside
    its static leaves (sizes, strides, level dims), and the static part as a
    hashable key."""
    leaves, tree = jax.tree_util.tree_flatten(batch)
    is_arr = tuple(isinstance(leaf, (jax.Array, np.ndarray)) or hasattr(leaf, "aval")
                   for leaf in leaves)
    statics = tuple(None if a else leaf for leaf, a in zip(leaves, is_arr))

    def rebuild(dyn):
        it = iter(dyn)
        return jax.tree_util.tree_unflatten(tree, [next(it) if a else x
                                                   for a, x in zip(is_arr, statics)])
    return [leaf for leaf, a in zip(leaves, is_arr) if a], rebuild, (tree, is_arr, statics)


# the JAX detector's module list cut into stages, each jitted alone: XLA's
# compile of the whole model takes about twice the sum of its stages'
STAGES = ((0, 3), (3, 4), (4, 6), (6, 7), (7, 8))  # 3D backbone, VSA, 2D + anchor head, ...


class Staged:
    """The JAX detector ``jm`` run a stage of its module list at a time
    (``stages``, slices of it; ``None`` is the model's own ``__call__``),
    each stage one ``jax.jit`` of a bound copy of the model; the batch
    dict's leaves that are not arrays (sizes, strides, level dims) are
    static. In training each stage also returns the batch statistics it
    updated, and the anchor head's stage its loss; ``grad`` of a function of
    the stages differentiates each jitted stage alone."""

    def __init__(self, jm, train, stages=STAGES):
        self.jm, self.train, self.stages, self.cache = jm, train, stages, {}

    def _stage(self, k):
        stage = self.stages[k]
        jm, train = self.jm, self.train

        def fn(variables, batch, key):
            bound = jm.bind(variables, rngs={"sampling": key} if train else None,
                            mutable=["batch_stats"] if train else False)
            if stage is None:
                out = bound(batch, train=train)
            else:
                out = batch
                for module in bound.module_list[stage[0]:stage[1]]:
                    out = module(out, train=train)
                    if train and type(module).__name__ == "AnchorHeadSingle":
                        out["rpn"] = module.get_loss(out["head_preds"], out["head_targets"])
            return out, (bound.variables["batch_stats"] if train else None)
        return fn

    def run(self, k, variables, batch, key=None):
        dyn, rebuild, static = _static_split(batch)
        sig = (k,) + static
        if sig not in self.cache:
            fn, box = self._stage(k), {}

            def f(variables, dyn, key):
                out, stats = fn(variables, rebuild(dyn), key)
                ol, ot = jax.tree_util.tree_flatten(out)
                oa = [hasattr(leaf, "dtype") for leaf in ol]
                box.update(tree=ot, is_arr=oa, statics=[None if a else x for x, a in zip(ol, oa)])
                return [x for x, a in zip(ol, oa) if a], stats
            self.cache[sig] = (jax.jit(f), box)
        jf, box = self.cache[sig]
        dyn, stats = jf(variables, dyn, key)
        it = iter(dyn)
        out = jax.tree_util.tree_unflatten(box["tree"], [next(it) if a else s for a, s in zip(
            box["is_arr"], box["statics"])])
        return out, stats

    def __call__(self, variables, batch, key=None):
        out = dict(batch, batch_size=B)
        for k in range(len(self.stages)):
            out, stats = self.run(k, variables, out, key)
            if self.train:
                variables = {"params": variables["params"], "batch_stats": stats}
        return out, variables.get("batch_stats")


@pytest.fixture(scope="module")
def pair():
    """Both detectors on the same seeded weights, and the JAX package's eval
    forward (its post-processing jitted alone)."""
    rng = np.random.default_rng(0)
    pts, mask, gt = _batch(rng)
    jm = build_jax(JaxCfg(CFG), num_class=3, dataset_info=JaxInfo(**INFO))
    jb = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask), "gt_boxes": jnp.asarray(gt)}
    shapes = jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), dict(b, batch_size=B), train=False), jb)
    variables = {"params": _fill_params(shapes["params"], rng),
                 "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}
    tm = build_network(CfgDict(CFG), num_class=3, dataset_info=DatasetInfo(**INFO), device="cpu")
    tm.load_state_dict(state_dict_from_jax_variables(variables, CFG), strict=True)
    staged = Staged(jm, train=False)
    out, _ = staged(variables, jb)
    keys = ("batch_cls_preds", "batch_box_preds", "batch_pred_valid", "roi_labels")
    out["final_box_dicts"] = jax.jit(lambda o: generic_post_processing(
        jm.model_cfg, jm.num_class, dict(o, has_class_labels=True)))({k: out[k] for k in keys})
    keep = ("point_coords", "point_coords_mask", "point_features", "point_cls_scores", "rois",
            "roi_labels", "roi_valid", "batch_cls_preds", "batch_box_preds", "final_box_dicts")
    return {"pts": pts, "mask": mask, "gt": gt, "variables": variables, "model": tm,
            "jm": jm, "staged": staged, "jeval": _np({k: out[k] for k in keep})}


@pytest.fixture(scope="module")
def steps(pair):
    """The JAX package's float64 training step, value and gradient, on the
    first stage's proposals and on ROIs handed in, stage by stage with the
    same compiles for both: the proposal layer's ROIs are replaced by the
    handed-in ones where ``use_given_rois`` is set."""
    jm, variables = pair["jm"], pair["variables"]
    given = _given_rois(np.random.default_rng(5), pair["gt"])
    orig = jax_pvrcnn_head.proposal_layer

    def proposals(batch, nms_cfg, **kwargs):
        out = orig(batch, nms_cfg, **kwargs)
        use = batch["use_given_rois"]
        for k in ("rois", "roi_scores", "roi_labels"):
            out[k] = jnp.where(use, batch[f"given_{k}"], out[k])
        return out

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        staged = Staged(jm, train=True)
        rec = recorded_priorities(jax_pvrcnn_head)

        def loss_fn(params, batch):
            out, stats = staged({"params": params, "batch_stats": v64["batch_stats"]}, batch,
                                jax.random.PRNGKey(SAMPLING_KEY))
            rpn_loss, tb = out["rpn"]
            loss = rpn_loss + out["point_head_loss"] + out["roi_head_loss"]
            return loss, ({**tb, **out["point_head_tb"], **out["roi_head_tb"]}, stats,
                          out["roi_sampling_priorities_jax"])

        base = {"points": jnp.asarray(pair["pts"], jnp.float64),
                "points_mask": jnp.asarray(pair["mask"]),
                "gt_boxes": jnp.asarray(pair["gt"], jnp.float64),
                "given_rois": jnp.asarray(given[0], jnp.float64),
                "given_roi_scores": jnp.asarray(given[1], jnp.float64),
                "given_roi_labels": jnp.asarray(given[2])}
        out = {}
        jax_pvrcnn_head.proposal_layer = proposals
        try:
            with rec:
                for case, use in (("proposals", False), ("given_rois", True)):
                    (loss, (tb, stats, pri)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                        v64["params"], dict(base, use_given_rois=jnp.asarray(use)))
                    out[case] = {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
                                 "grads": _np(grads), "stats": _np(stats),
                                 "priorities": np.asarray(pri), "rois": given if use else None}
        finally:
            jax_pvrcnn_head.proposal_layer = orig
    out["staged"], out["base"], out["v64"] = staged, base, v64
    return out


# ------------------------------------------------------------------ modules


def test_bilinear_interpolate_bev_matches_jax():
    rng = np.random.default_rng(1)
    bev = rng.normal(size=(2, 6, 9, 5)).astype(np.float32)  # NHWC
    xy = rng.uniform(-1.5, 10.5, (2, 40, 2)).astype(np.float32)
    xy[0, :6] = [[0, 0], [8, 5], [8.0, 0.5], [3.5, 5.0], [-0.5, 2.0], [9.7, 6.2]]  # on and past
    want = np.asarray(jax.jit(jax_bilinear)(jnp.asarray(bev), jnp.asarray(xy)))
    got = bilinear_interpolate_bev(_t(bev).permute(0, 3, 1, 2), _t(xy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_voxel_centers_match_jax_exactly():
    rng = np.random.default_rng(2)
    dims = (11, 32, 32)
    limit = int(np.prod(dims))
    ids = np.sort(rng.choice(limit, (2, 50), replace=False), axis=1)
    ids[1, 40:] = limit
    args = (dims, 4, INFO["voxel_size"], INFO["point_cloud_range"])
    want_c, want_v = jax.jit(lambda i: jax_voxel_centers(i, *args))(jnp.asarray(ids, jnp.int32))
    got_c, got_v = get_voxel_centers_from_ids(_t(ids), *args)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


LEVELS = {"x_conv3": ((11, 32, 32), 4, 64, 150), "x_conv4": ((5, 16, 16), 8, 128, 80)}


def _vsa_inputs(rng):
    """A BEV map and seeded sparse levels (sorted ids, padding at the end)."""
    bev = rng.normal(size=(B, 16, 16, 16)).astype(np.float32)
    levels = {}
    for name, (dims, ds, c, v) in LEVELS.items():
        limit = int(np.prod(dims))
        ids = np.sort(rng.choice(limit, (B, v), replace=False), axis=1)
        ids[1, v - 15:] = limit
        feats = np.where((ids < limit)[..., None], rng.normal(size=(B, v, c)), 0).astype(np.float32)
        levels[name] = (ids, feats, dims, ds)
    return bev, levels


def _jax_vsa_run(vsa, levels, train):
    def run(v, p, m, s, f3, f4):
        feats = {"x_conv3": f3, "x_conv4": f4}
        batch = {"points": p, "points_mask": m, "spatial_features": s,
                 "spatial_features_stride": 8, "multi_scale_3d_features": {
                     k: (jnp.asarray(ids, jnp.int32), feats[k], dims, ds)
                     for k, (ids, _, dims, ds) in levels.items()}}
        if not train:
            return vsa.apply(v, batch, train=False), None
        return vsa.apply(v, batch, train=True, mutable=["batch_stats"])
    return run


def test_vsa_matches_jax():
    rng = np.random.default_rng(3)
    pts, mask, _ = _batch(rng)
    bev, levels = _vsa_inputs(rng)
    cfg = CFG["PFE"]
    vsa = JaxVSA(model_cfg=JaxCfg(cfg), voxel_size=INFO["voxel_size"],
                 point_cloud_range=INFO["point_cloud_range"], num_bev_features=16,
                 num_rawpoint_features=4)
    args = (jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(bev),
            jnp.asarray(levels["x_conv3"][1]), jnp.asarray(levels["x_conv4"][1]))
    shapes = jax.eval_shape(lambda *a: vsa.init(jax.random.PRNGKey(0), {
        "points": a[0], "points_mask": a[1], "spatial_features": a[2],
        "multi_scale_3d_features": {k: (jnp.asarray(ids, jnp.int32), f, dims, ds) for (k, (ids, _, dims, ds)), f
                                    in zip(levels.items(), a[3:])}}), *args)
    variables = {"params": _fill_params(shapes["params"], rng),
                 "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}
    tvsa = VoxelSetAbstraction(CfgDict(cfg), INFO["voxel_size"], INFO["point_cloud_range"], 16, 4,
                               {"x_conv3": 64, "x_conv4": 128})
    sd = {k[len("pfe."):]: v for k, v in state_dict_from_jax_variables(
        {name: {"pfe": tree} for name, tree in variables.items()}, {"PFE": cfg}).items()}
    tvsa.load_state_dict(sd, strict=True)
    tb = {"points": _t(pts), "points_mask": _t(mask), "spatial_features_stride": 8,
          "spatial_features": _t(bev).permute(0, 3, 1, 2),
          "multi_scale_3d_features": {k: (_t(ids), _t(f), dims, ds)
                                      for k, (ids, f, dims, ds) in levels.items()}}
    for train in (False, True):
        jout, upd = _np(jax.jit(_jax_vsa_run(vsa, levels, train))(variables, *args))
        tout = tvsa.train(train)(tb)
        np.testing.assert_array_equal(tout["point_coords"].numpy(), jout["point_coords"])
        np.testing.assert_array_equal(tout["point_coords_mask"].numpy(), jout["point_coords_mask"])
        assert not jout["point_coords_mask"][1, 0] and jout["point_coords_mask"].sum() == B * K - 1
        for key in ("point_features_before_fusion", "point_features"):
            np.testing.assert_allclose(tout[key].detach().numpy(), jout[key], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{key} train={train}")
        if train:
            bn = tvsa.vsa_point_feature_fusion[1]
            np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["fusion_bn"]["mean"], atol=1e-6)
            np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["fusion_bn"]["var"], atol=1e-6)
    # each source's ball queries about the keypoints, in both packages
    kp, kp_mask = tout["point_coords"], tout["point_coords_mask"]
    sources = [("raw_points", _t(pts[..., :3]), _t(mask))]
    for name, (ids, _, dims, ds) in levels.items():
        centers, valid = get_voxel_centers_from_ids(_t(ids), dims, ds, INFO["voxel_size"],
                                                    INFO["point_cloud_range"])
        sources.append((name, centers, valid))
    for name, xyz, valid in sources:
        sa = cfg["SA_LAYER"][name]
        for radius, nsample in zip(sa["POOL_RADIUS"], sa["NSAMPLE"]):
            ji, je = jax.jit(jax_pn2.ball_query, static_argnums=(0, 1))(
                float(radius), int(nsample), jnp.asarray(xyz.numpy()), jnp.asarray(kp.numpy()),
                mask=jnp.asarray(valid.numpy()), new_mask=jnp.asarray(kp_mask.numpy()))
            ti, te = pn2.ball_query(float(radius), int(nsample), xyz, kp, mask=valid,
                                    new_mask=kp_mask)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=name)
            np.testing.assert_array_equal(te.numpy(), np.asarray(je), err_msg=name)


def test_ball_queries_in_blocks_equal_the_whole_matrix(monkeypatch):
    rng = np.random.default_rng(4)
    xyz = _t(rng.uniform(-2, 2, (2, 300, 3)).astype(np.float32))
    new = _t(rng.uniform(-2, 2, (2, 70, 3)).astype(np.float32))
    mask = torch.ones((2, 300), dtype=torch.bool)
    mask[1, 250:] = False
    new_mask = torch.ones((2, 70), dtype=torch.bool)
    new_mask[0, 3] = False
    whole = pointnet2_modules.ball_query_blocks([0.5, 1.0], [8, 16], xyz, new, mask, new_mask)
    monkeypatch.setattr(pointnet2_modules, "QUERY_BLOCK_ENTRIES", 2 * 300 * 9)  # blocks of 9 rows
    blocks = pointnet2_modules.ball_query_blocks([0.5, 1.0], [8, 16], xyz, new, mask, new_mask)
    for (wi, we), (bi, be) in zip(whole, blocks):
        assert torch.equal(wi, bi) and torch.equal(we, be)


def test_point_head_simple_matches_jax():
    rng = np.random.default_rng(5)
    pts, mask, gt = _batch(rng)
    head_cfg = CFG["POINT_HEAD"]
    feats = rng.normal(size=(B, N, 24)).astype(np.float32)
    jhead = JaxPointHeadSimple(model_cfg=JaxCfg(head_cfg), num_class=1, input_channels=24)
    jb = {"point_features_before_fusion": jnp.asarray(feats), "point_features": jnp.zeros((B, N, 3)),
          "point_coords": jnp.asarray(pts[..., :3]), "point_coords_mask": jnp.asarray(mask),
          "gt_boxes": jnp.asarray(gt)}
    shapes = jax.eval_shape(lambda b: jhead.init(jax.random.PRNGKey(1), b, train=False), jb)
    v = {"params": _fill_params(shapes["params"], rng),
         "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}

    def run(v, batch):
        out, _ = jhead.apply(v, batch, train=True, mutable=["batch_stats"])
        extend = enlarge_box3d(batch["gt_boxes"], head_cfg["TARGET_CONFIG"]["GT_EXTRA_WIDTH"])
        targets = jhead.apply(v, batch["point_coords"], batch["point_coords_mask"],
                              batch["gt_boxes"], extend_gt_boxes=extend, set_ignore_flag=True,
                              method=JaxPointHeadSimple.assign_stack_targets)
        return out, targets, jhead.apply(v, batch, train=False)

    jout, jt, jeval = _np(jax.jit(run)(v, jb))
    thead = PointHeadSimple(CfgDict(head_cfg), 24, 1)
    sd = {k[len("point_head."):]: val for k, val in state_dict_from_jax_variables(
        {name: {"point_head": tree} for name, tree in v.items()}, {"POINT_HEAD": head_cfg}).items()}
    thead.load_state_dict(sd, strict=True)
    labels, _, _ = thead.stack_targets(_t(pts[..., :3]), _t(mask), _t(gt))
    np.testing.assert_array_equal(labels.numpy(), jt["point_cls_labels"])
    assert (labels > 0).sum() >= 30 and (labels == -1).sum() > 0
    batch = {k: _t(np.asarray(val)) for k, val in jb.items()}
    teval = copy.deepcopy(thead).eval()(batch)  # before training moves the statistics
    tout = thead.train()(batch)
    assert tout["point_head_loss"].item() == pytest.approx(float(jout["point_head_loss"]), rel=1e-5)
    for k, val in jout["point_head_tb"].items():
        assert tout["point_head_tb"][k].item() == pytest.approx(float(val), rel=1e-5), k
    for got, want in ((tout, jout), (teval, jeval)):
        np.testing.assert_allclose(got["point_cls_scores"].detach().numpy(),
                                   want["point_cls_scores"], atol=1e-5, rtol=0)


def _rois(rng, b, r):
    rois = np.concatenate([rng.uniform(-5, 5, (b, r, 3)), rng.uniform(0.5, 4, (b, r, 3)),
                           rng.uniform(-3.2, 3.2, (b, r, 1))], -1).astype(np.float32)
    rois[:, -2:] = 0  # padding rows
    return rois


def test_dense_grid_and_roi_grid_points_match_jax():
    """Equal to the JAX package's op-by-op run; within 2.4e-7 of its jitted
    code, which fuses some of the multiply-adds."""
    rng = np.random.default_rng(6)
    rois = _rois(rng, 2, 9)
    g = CFG["ROI_HEAD"]["ROI_GRID_POOL"]["GRID_SIZE"]

    def grid(r):
        local = jax_dense_grid(r, g)
        b, m = r.shape[:2]
        rot = rotate_points_along_z_jnp(local.reshape(b * m, g ** 3, 3), r[..., 6].reshape(b * m))
        return local, (rot.reshape(b, m, g ** 3, 3) + r[..., None, 0:3]).reshape(b, m * g ** 3, 3)

    head = PVRCNNHead(CfgDict(CFG["ROI_HEAD"]), 1, 8)
    got = (get_dense_grid_points(_t(rois), g).numpy(), head.roi_grid_points(_t(rois)).numpy())
    eager = _np(grid(jnp.asarray(rois)))
    np.testing.assert_array_equal(got[0], eager[0])
    np.testing.assert_allclose(got[1], eager[1], atol=5e-7, rtol=0)
    for a, b in zip(got, _np(jax.jit(grid)(jnp.asarray(rois)))):
        np.testing.assert_allclose(a, b, atol=2.4e-7 * 4, rtol=0)


def _head_inputs(rng):
    pts, mask, gt = _batch(rng)
    kp = pts[:, :K, :3].copy()
    kp_mask = mask[:, :K].copy()
    return {"point_features": rng.normal(size=(B, K, 12)).astype(np.float32),
            "point_cls_scores": rng.uniform(0, 1, (B, K)).astype(np.float32),
            "point_coords": kp, "point_coords_mask": kp_mask, "gt_boxes": gt}


@pytest.fixture(scope="module")
def roi_head_pair():
    """The ROI head alone in both packages on seeded inputs: eval on ROIs
    handed in (jittered gt boxes and random ones), training with the JAX
    priorities."""
    rng = np.random.default_rng(7)
    inputs = _head_inputs(rng)
    rois, scores, labels = _given_rois(rng, inputs["gt_boxes"])
    rois[:, 20:] = _rois(rng, B, P_TRAIN - 20)[:, :P_TRAIN - 20]
    labels[:, 20:] = np.where(rois[:, 20:, 3] > 0, 1, 0)
    batch = dict(inputs, rois=rois, roi_scores=scores, roi_labels=labels,
                 roi_valid=rois[..., 3] > 0)
    head_cfg = CFG["ROI_HEAD"]
    jhead = JaxPVRCNNHead(model_cfg=JaxCfg(head_cfg), num_class=1, input_channels=12)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: jhead.init(jax.random.PRNGKey(0), b, train=False), jb)
    v = {"params": _fill_params(shapes["params"], rng),
         "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}

    def run(v, b):
        with recorded_priorities(jax_pvrcnn_head):
            out, _ = jhead.apply(v, b, train=True, mutable=["batch_stats"],
                                 rngs={"sampling": jax.random.PRNGKey(3)})
        return jhead.apply(v, b, train=False), out

    jeval, jtrain = _np(jax.jit(run)(v, jb))
    return {"batch": batch, "v": v, "jeval": jeval, "jtrain": jtrain,
            "priorities": jtrain["roi_sampling_priorities_jax"]}


def _torch_roi_head(variables, permute=True, monkeypatch=None):
    head = PVRCNNHead(CfgDict(CFG["ROI_HEAD"]), 1, 12)
    if not permute:
        monkeypatch.setattr(jax_weights, "grid_major_to_channel_major", lambda k, g: np.asarray(k))
    sd = {k[len("roi_head."):]: val for k, val in state_dict_from_jax_variables(
        {name: {"roi_head": tree} for name, tree in variables.items()},
        {"ROI_HEAD": CFG["ROI_HEAD"]}).items()}
    head.load_state_dict(sd, strict=True)
    return head


def test_pvrcnn_head_matches_jax(roi_head_pair):
    p = roi_head_pair
    head = _torch_roi_head(p["v"])
    batch = {k: _t(v) for k, v in p["batch"].items()}
    with torch.no_grad():
        tout = head.eval()(batch)
    for key in ("batch_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(tout[key].numpy(), p["jeval"][key], atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    tout = head.train()(dict(batch, roi_sampling_priorities=_t(p["priorities"])))
    jtb = p["jtrain"]["roi_head_tb"]
    assert jtb["rcnn_loss_reg"] > 0 and jtb["rcnn_loss_corner"] > 0
    assert set(tout["roi_head_tb"]) == set(jtb)
    for k, v in jtb.items():
        assert tout["roi_head_tb"][k].item() == pytest.approx(float(v), rel=1e-5, abs=1e-7), k


def test_first_shared_layer_needs_the_grid_permutation(roi_head_pair, monkeypatch):
    """Loaded without the permutation, the head's scores leave JAX's."""
    p = roi_head_pair
    kernel = np.arange(27 * 4 * 2, dtype=np.float32).reshape(27 * 4, 2)  # rows g * C + c
    moved = jax_weights.grid_major_to_channel_major(kernel, 27)
    assert moved[3 * 27 + 11, 0] == kernel[11 * 4 + 3, 0]  # row c * G^3 + g
    head = _torch_roi_head(p["v"], permute=False, monkeypatch=monkeypatch)
    with torch.no_grad():
        tout = head.eval()({k: _t(v) for k, v in p["batch"].items()})
    err = np.abs(tout["batch_cls_preds"].numpy() - p["jeval"]["batch_cls_preds"]).max()
    assert err > 1e-2, err


def test_three_class_anchor_head_in_training_matches_jax():
    rng = np.random.default_rng(8)
    _, _, gt = _batch(rng)
    head_cfg = CFG["DENSE_HEAD"]
    args = dict(input_channels=8, num_class=3, class_names=CLASSES,
                grid_size=INFO["grid_size"], point_cloud_range=INFO["point_cloud_range"],
                voxel_size=INFO["voxel_size"])
    jhead = JaxAnchorHead(model_cfg=JaxCfg(head_cfg), predict_boxes_when_training=True, **args)
    x = rng.normal(size=(B, 16, 16, 8)).astype(np.float32)
    jb = {"spatial_features_2d": jnp.asarray(x), "gt_boxes": jnp.asarray(gt)}
    shapes = jax.eval_shape(lambda b: jhead.init(jax.random.PRNGKey(0), b, train=False), jb)
    v = {"params": _fill_params(shapes["params"], rng)}

    def run(v, b):
        out = jhead.apply(v, b, train=True)
        return out, jhead.apply(v, out["head_preds"], out["head_targets"],
                                method=JaxAnchorHead.get_loss)

    jout, (jloss, jtb) = _np(jax.jit(run)(v, jb))
    thead = AnchorHeadSingle(CfgDict(head_cfg), predict_boxes_when_training=True, **args)
    sd = {k[len("dense_head."):]: val for k, val in state_dict_from_jax_variables(
        {"params": {"dense_head": v["params"]}}, {"DENSE_HEAD": head_cfg}).items()}
    thead.load_state_dict(sd, strict=True)
    assert thead.anchors.shape[0] == 16 * 16 * 6
    tout = thead.train()({"spatial_features_2d": _t(x).permute(0, 3, 1, 2), "gt_boxes": _t(gt)})
    tt, jt = tout["head_targets"], jout["head_targets"]
    np.testing.assert_array_equal(tt["box_cls_labels"].numpy(), jt["box_cls_labels"])
    assert set(np.unique(jt["box_cls_labels"])) >= {-1, 0, 1, 2, 3}
    np.testing.assert_allclose(tt["box_reg_targets"].numpy(), jt["box_reg_targets"], atol=1e-5)
    loss, tb = thead.get_loss(tout["head_preds"], tt)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k, val in jtb.items():
        assert tb[k].item() == pytest.approx(float(val), rel=1e-5), k
    for key in ("batch_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(tout[key].detach().numpy(), jout[key], atol=1e-5, rtol=1e-5,
                                   err_msg=key)


# -------------------------------------------------------------- the detector


def test_weight_bridge_round_trips_through_pcdet_names(pair):
    """Every JAX leaf labelled with distinct values: each lands once in the
    pcdet-named state dict the port loads, and reading the labels back
    rebuilds every leaf."""
    flat, tree = jax.tree_util.tree_flatten_with_path(pair["variables"])
    offsets = np.cumsum([0] + [np.size(leaf) for _, leaf in flat])
    labelled = jax.tree_util.tree_unflatten(tree, [
        (np.arange(np.size(leaf), dtype=np.float64) + lo + 1).reshape(np.shape(leaf))
        for (_, leaf), lo in zip(flat, offsets)])
    sd = state_dict_from_jax_variables(labelled, CFG)
    assert set(sd) == set(pair["model"].state_dict())
    rebuilt = np.zeros(offsets[-1] + 1)
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        vals = t.numpy().ravel().astype(np.int64)
        assert (rebuilt[vals] == 0).all(), name
        rebuilt[vals] = vals
    assert (rebuilt[1:] == np.arange(1, offsets[-1] + 1)).all()
    copy.deepcopy(pair["model"]).load_state_dict(state_dict_from_jax_variables(
        pair["variables"], CFG), strict=True)


def test_eval_forward_matches_jax(pair):
    jout = pair["jeval"]
    with torch.no_grad():
        tout = pair["model"]({"points": _t(pair["pts"]), "points_mask": _t(pair["mask"])})
    for key in ("point_coords", "point_coords_mask", "roi_valid", "roi_labels"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    assert not jout["point_coords_mask"][1, 0] and jout["roi_valid"].sum() > 8
    for key, atol in (("point_features", 1e-5), ("point_cls_scores", 1e-5), ("rois", 1e-4),
                      ("batch_cls_preds", 1e-4), ("batch_box_preds", 1e-4)):
        np.testing.assert_allclose(tout[key].numpy(), jout[key], atol=atol, rtol=1e-5, err_msg=key)
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = jout["final_box_dicts"]
    pp = CFG["POST_PROCESSING"]
    compared = 0
    for b in range(B):
        compared += match_surviving_boxes(
            {k: v[b] for k, v in got.items()}, {k: v[b] for k, v in want.items()},
            heat_scores=np.zeros(0), top_k=1, score_thresh=pp["SCORE_THRESH"],
            post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"], margin=1e-4, box_atol=1e-4,
            box_rtol=0, score_atol=1e-5, min_matched=1)
    assert compared >= 2


@pytest.mark.parametrize("case", ["proposals", "given_rois"])
def test_train_step_matches_jax_in_float64(pair, steps, case):
    from pcp_tpu_torch.models.roi_heads import pvrcnn_head

    jtrain = steps[case]
    model = copy.deepcopy(pair["model"]).to(torch.float64).train()
    batch = {"points": _t(pair["pts"], torch.float64), "points_mask": _t(pair["mask"]),
             "gt_boxes": _t(pair["gt"], torch.float64),
             "roi_sampling_priorities": _t(jtrain["priorities"], torch.float64)}
    if jtrain["rois"] is not None:
        rois, scores, labels = jtrain["rois"]
        batch.update(rois=_t(rois, torch.float64), roi_scores=_t(scores, torch.float64),
                     roi_labels=_t(labels, torch.int64))
    drawn, orig = [], pvrcnn_head.assign_targets
    pvrcnn_head.assign_targets = lambda *a, **k: drawn.append(orig(*a, **k)) or drawn[-1]
    try:
        out = model(batch)
    finally:
        pvrcnn_head.assign_targets = orig
    out["loss"].backward()
    assert out["loss"].item() == pytest.approx(jtrain["loss"], rel=1e-6)
    assert set(out["tb_dict"]) == set(jtrain["tb"])
    for k, v in jtrain["tb"].items():
        assert out["tb_dict"][k].item() == pytest.approx(v, rel=1e-6, abs=1e-9), k
    want = tensors_from_jax_params(jtrain["grads"], CFG)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    silent = {n for n, w in want.items() if not w.abs().max().item()}
    if case == "given_rois":
        assert int(drawn[0]["reg_valid_mask"].sum()) >= 4
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


def test_shipped_yaml_with_the_z_range_builds_and_forwards():
    """``pv_rcnn.yaml`` at its published widths with ``PVRCNN_Z_RANGE`` (40
    z slices of 0.2 m): a 12.8 m square of it forwards on the CPU, 128
    keypoints (4096 as shipped)."""
    cfg, info, model = build(CFG_PVRCNN, device="cpu", set_cfgs=PVRCNN_Z_RANGE + [
        "DATA_CONFIG.POINT_CLOUD_RANGE", "[0.0, -6.4, -3.0, 12.8, 6.4, 5.0]",
        "MODEL.PFE.NUM_KEYPOINTS", "128"])
    assert info.grid_size == (128, 128, 40)
    assert model.pfe.num_point_features_before_fusion == 544
    assert model.map_to_bev.num_bev_features == 256
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.uniform([0.5, -6, -2.5], [12, 6, 2.0], (1, 600, 3)),
                          rng.uniform(0, 1, (1, 600, 1))], -1).astype(np.float32)
    with torch.no_grad():
        out = model({"points": _t(pts), "points_mask": torch.ones((1, 600), dtype=torch.bool)})
    assert out["spatial_features"].shape[1] == 256
    assert out["rois"].shape == (1, 300, 7) and out["point_features"].shape == (1, 128, 128)
    assert torch.isfinite(out["final_box_dicts"]["pred_boxes"]).all()


# PV-RCNN at a tiny size through --set: pv_rcnn.yaml's structure (the z
# range override, the sparse backbone as published), narrow 2D and point
# widths, a 51.2 m square, 64 keypoints, few ROIs
TINY_PVRCNN = PVRCNN_Z_RANGE[:1] + ["[0.0, -25.6, -3.0, 51.2, 25.6, 5.0]"] + [
    "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "2048",
    "MODEL.BACKBONE_2D.LAYER_NUMS", "[1, 1]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16, 16]",
    "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16, 16]",
    "MODEL.PFE.NUM_KEYPOINTS", "64", "MODEL.PFE.NUM_OUTPUT_FEATURES", "16",
    "MODEL.PFE.SA_LAYER.raw_points.MLPS", "[[8], [8]]",
    "MODEL.PFE.SA_LAYER.x_conv3.MLPS", "[[8], [8]]", "MODEL.PFE.SA_LAYER.x_conv4.MLPS", "[[8], [8]]",
    "MODEL.POINT_HEAD.CLS_FC", "[16]",
    "MODEL.ROI_HEAD.SHARED_FC", "[16, 16]", "MODEL.ROI_HEAD.CLS_FC", "[16]",
    "MODEL.ROI_HEAD.REG_FC", "[16]", "MODEL.ROI_HEAD.ROI_GRID_POOL.GRID_SIZE", "3",
    "MODEL.ROI_HEAD.ROI_GRID_POOL.MLPS", "[[8], [8]]",
    "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE", "64",
    "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE", "32",
    "MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE", "16",
]


def _train_and_evaluate_through_the_clis(tmp_path, extra_sets=()):
    """The custom tree's infos, one epoch (one b2 step with the config's
    adam_onecycle) of the tiny model through the train CLI, then the test
    CLI's KITTI AP table through MAP_CLASS_TO_KITTI. Returns the config."""
    from pcp_tpu_torch.config import cfg_from_list, cfg_from_yaml_file
    from pcp_tpu_torch.datasets.custom.custom_dataset import create_custom_infos
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli
    from torch_fake_kitti import make_custom_tree

    root = make_custom_tree(tmp_path / "custom")
    cfg = cfg_from_yaml_file(CFG_PVRCNN, CfgDict())
    cfg_from_list(list(extra_sets) + TINY_PVRCNN, cfg)
    create_custom_infos(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root, root)
    sets = ["DATA_CONFIG.DATA_PATH", str(root)] + list(extra_sets) + TINY_PVRCNN
    common = ["--cfg_file", CFG_PVRCNN, "--batch_size", "2", "--workers", "0", "--device", "cpu",
              "--extra_tag", "tiny", "--output_root", str(tmp_path / "out")]
    out = train_cli.main(common + ["--epochs", "1", "--seed", "3", "--num_epochs_to_eval", "0",
                                   "--precise_bn", "0", "--set", *sets])
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    assert set(out["launches"].values()) == {0}  # PV-RCNN reaches no CUDA kernel
    run_dir = tmp_path / "out" / "cfgs" / "custom_models" / "pv_rcnn" / "tiny"
    result = test_cli.main(common + ["--ckpt", str(run_dir / "ckpt" / "checkpoint_epoch_1.pth"),
                                     "--set", *sets])
    assert "Car_3d/moderate_R40" in result and "Cyclist_3d/moderate_R40" in result
    return cfg


def test_pvrcnn_trains_and_evaluates_through_the_clis(tmp_path):
    _train_and_evaluate_through_the_clis(tmp_path)


# ---------------------------------------------------------------- PV-RCNN++

PP = _ppcfg()
PPCFG = copy.deepcopy(CFG)
PPCFG["NAME"] = "PVRCNNPlusPlus"
PPCFG["PFE"].update(SAMPLE_METHOD="SPC", SPC_SAMPLING=PP["PFE"]["SPC_SAMPLING"])
PPCFG["PFE"]["SA_LAYER"]["raw_points"] = PP["PFE"]["SA_LAYER"]["raw_points"]
PPCFG["ROI_HEAD"]["ROI_GRID_POOL"] = PP["ROI_HEAD"]["ROI_GRID_POOL"]
# the modules PV-RCNN++ runs after its proposals; the others are PV-RCNN's
TAIL = ("pfe", "point_head", "roi_head")
TAIL_CFG = {k: v for k, v in PPCFG.items()
            if k in ("NAME", "PFE", "POINT_HEAD", "ROI_HEAD", "POST_PROCESSING")}


def _vp_cfg(agg):
    return {"NAME": "VectorPoolAggregationModuleMSG", "NUM_REDUCED_CHANNELS": 6,
            "NUM_CHANNELS_OF_LOCAL_AGGREGATION": 4, "LOCAL_AGGREGATION_TYPE": agg,
            "MSG_POST_MLPS": [16],
            "GROUP_CFG_0": {"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.8,
                            "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16, 16]},
            "GROUP_CFG_1": {"NUM_LOCAL_VOXEL": [3, 3, 3], "MAX_NEIGHBOR_DISTANCE": 1.5,
                            "NEIGHBOR_NSAMPLE": 16, "POST_MLPS": [16]}}


@pytest.mark.parametrize("agg", ["local_interpolation", "voxel_avg_pool"])
def test_vector_pool_matches_jax(agg):
    """Two groups, the input reduced 8 -> 6 channels; a query off the cloud
    (an empty ball) and padding queries and points. Eval and training
    within 1e-5, the BN statistics within 1e-6; the lattice exactly."""
    np.testing.assert_array_equal(local_voxel_offsets((3, 2, 4), 1.2).numpy(),
                                  np.asarray(jax_local_voxel_offsets((3, 2, 4), 1.2)))
    rng = np.random.default_rng(11)
    cfg = _vp_cfg(agg)
    xyz = rng.uniform(-3, 3, (B, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(B, 64, 8)).astype(np.float32)
    mask = np.ones((B, 64), bool)
    mask[1, 40:] = False
    new_xyz = rng.uniform(-3, 3, (B, 12, 3)).astype(np.float32)
    new_xyz[0, :3] = xyz[0, :3]  # queries on support points
    new_xyz[0, 3] = 20.0  # an empty ball
    new_mask = np.ones((B, 12), bool)
    new_mask[1, -3:] = False
    jm = JaxVectorPoolMSG(input_channels=8, config=JaxCfg(cfg))
    args = [jnp.asarray(a) for a in (xyz, feats, mask, new_xyz, new_mask)]
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a), *args)
    v = {"params": _fill_params(shapes["params"], rng),
         "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}
    want_eval, (want_train, upd) = _np(jax.jit(lambda v, *a: (
        jm.apply(v, *a), jm.apply(v, *a, train=True, mutable=["batch_stats"])))(v, *args))
    tm = VectorPoolAggregationModuleMSG(8, CfgDict(cfg))
    sd = {}
    jax_weights._vector_pool(sd, "vp", v["params"], v["batch_stats"])
    tm.load_state_dict({k[len("vp."):]: val for k, val in sd.items()}, strict=True)
    targs = [_t(a) for a in (xyz, feats, mask, new_xyz, new_mask)]
    with torch.no_grad():
        got_eval = tm.eval()(*targs)
        got_train = tm.train()(*targs)
    np.testing.assert_allclose(got_eval.numpy(), want_eval, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), want_train, atol=1e-5, rtol=1e-5)
    assert np.abs(want_eval[1, -3:]).max() == 0 and np.abs(want_eval[0, 3]).max() > 0
    sd = {}
    jax_weights._vector_pool(sd, "vp", v["params"], upd["batch_stats"])
    for name, val in tm.state_dict().items():
        if ".running_" in name:
            np.testing.assert_allclose(val.numpy(), sd[f"vp.{name}"].numpy(), atol=1e-6,
                                       err_msg=name)


def test_spc_keypoints_and_vector_pool_vsa_match_jax():
    """The VSA with SPC sampling and VectorPool raw points, as many
    keypoints as points, so that FPS takes every SPC candidate before any
    other point: the valid keypoints are the candidate set, equal to the
    JAX package's, and the second cloud, without a ROI, falls back to all
    its valid points. Keypoints equal, features within 1e-5 in eval and
    training."""
    rng = np.random.default_rng(12)
    pts, mask, gt = _batch(rng)
    bev, levels = _vsa_inputs(rng)
    rois = np.zeros((B, 6, 7), np.float32)
    rois[0, :3] = gt[0, :3, :7] + rng.normal(0, 0.2, (3, 7)).astype(np.float32)
    rois[0, :3, 3:6] = np.abs(rois[0, :3, 3:6])
    cfg = copy.deepcopy(PPCFG["PFE"])
    cfg["NUM_KEYPOINTS"] = N
    vsa = JaxVSA(model_cfg=JaxCfg(cfg), voxel_size=INFO["voxel_size"],
                 point_cloud_range=INFO["point_cloud_range"], num_bev_features=16,
                 num_rawpoint_features=4)
    batch = {"points": pts, "points_mask": mask, "spatial_features": bev, "rois": rois,
             "spatial_features_stride": 8,
             "multi_scale_3d_features": {k: (ids.astype(np.int32), f, dims, ds)
                                         for k, (ids, f, dims, ds) in levels.items()}}
    dyn, rebuild, _ = _static_split(batch)
    shapes = jax.eval_shape(lambda d: vsa.init(jax.random.PRNGKey(0), rebuild(d)), dyn)
    v = {"params": _fill_params(shapes["params"], rng),
         "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}
    want = _np(jax.jit(lambda v, d: (
        vsa.apply(v, rebuild(d)),
        vsa.apply(v, rebuild(d), train=True, mutable=["batch_stats"])[0]))(v, dyn))
    tvsa = VoxelSetAbstraction(CfgDict(cfg), INFO["voxel_size"], INFO["point_cloud_range"], 16, 4,
                               {"x_conv3": 64, "x_conv4": 128})
    sd = {k[len("pfe."):]: val for k, val in state_dict_from_jax_variables(
        {name: {"pfe": tree} for name, tree in v.items()}, {"PFE": cfg}).items()}
    tvsa.load_state_dict(sd, strict=True)
    tb = {"points": _t(pts), "points_mask": _t(mask), "spatial_features_stride": 8,
          "spatial_features": _t(bev).permute(0, 3, 1, 2), "rois": _t(rois),
          "multi_scale_3d_features": {k: (_t(ids), _t(f), dims, ds)
                                      for k, (ids, f, dims, ds) in levels.items()}}
    cand = spc_candidates(_t(pts[..., :3]), _t(mask), _t(rois),
                          cfg["SPC_SAMPLING"]["SAMPLE_RADIUS_WITH_ROI"]).numpy()
    assert 0 < cand[0].sum() < mask[0].sum() and (cand[1] == mask[1]).all()
    for jout, train in zip(want, (False, True)):
        with torch.no_grad():
            tout = tvsa.train(train)(tb)
        kp_mask = jout["point_coords_mask"]
        np.testing.assert_array_equal(tout["point_coords_mask"].numpy(), kp_mask)
        np.testing.assert_array_equal(tout["point_coords"].numpy(), jout["point_coords"])
        for b in range(B):  # the valid keypoints are exactly the candidates
            taken = {tuple(p) for p in jout["point_coords"][b][kp_mask[b]]}
            assert taken == {tuple(p) for p in pts[b, cand[b], :3]}
        for key in ("point_features_before_fusion", "point_features"):
            np.testing.assert_allclose(tout[key].numpy(), jout[key], atol=1e-5, rtol=1e-5,
                                       err_msg=f"{key} train={train}")


def _pp_variables(pair, tail):
    """PV-RCNN++'s variables: PV-RCNN's for the modules the two share, the
    tail's for the rest."""
    return {col: {**{k: v for k, v in pair["variables"][col].items() if k not in TAIL},
                  **tail[col]} for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def pp_pair(pair):
    """PV-RCNN++ in both packages on PV-RCNN's seeded weights for the
    modules they share (the sparse and BEV backbones, the anchor head) and
    seeded ones for the rest. The JAX side runs PV-RCNN's jitted stages up
    to the anchor head (its 3D backbone compiled once for both detectors),
    then a JAX PV-RCNN++ built of the other modules alone: its own
    ``__call__`` draws the proposals, then runs the PFE, the point head and
    the ROI head, and post-processes."""
    rng = np.random.default_rng(13)
    jt = build_jax(JaxCfg(TAIL_CFG), num_class=3, dataset_info=JaxInfo(**INFO))
    out = {"points": jnp.asarray(pair["pts"]), "points_mask": jnp.asarray(pair["mask"]),
           "gt_boxes": jnp.asarray(pair["gt"]), "batch_size": B}
    for k in (0, 2):
        out, _ = pair["staged"].run(k, pair["variables"], out)
    dyn, rebuild, _ = _static_split(out)
    shapes = jax.eval_shape(lambda d: jt.init(jax.random.PRNGKey(0), rebuild(d)), dyn)
    tail = {"params": _fill_params(shapes["params"], rng),
            "batch_stats": randomize_batch_stats(shapes["batch_stats"], rng)}
    jout, _ = Staged(jt, train=False, stages=(None,)).run(0, tail, out)
    variables = _pp_variables(pair, tail)
    tm = build_network(CfgDict(PPCFG), num_class=3, dataset_info=DatasetInfo(**INFO),
                       device="cpu")
    tm.load_state_dict(state_dict_from_jax_variables(variables, PPCFG), strict=True)
    keep = ("point_coords", "point_coords_mask", "point_features", "point_cls_scores", "rois",
            "roi_labels", "roi_valid", "batch_cls_preds", "batch_box_preds", "final_box_dicts")
    return {"jt": jt, "tail": tail, "variables": variables, "model": tm,
            "jeval": _np({k: jout[k] for k in keep})}


@pytest.fixture(scope="module")
def pp_step(pair, steps, pp_pair):
    """The JAX PV-RCNN++'s float64 training step on ROIs handed in
    (jittered gt boxes): PV-RCNN's jitted training stages up to the anchor
    head (the 3D backbone's compile shared with ``steps``), then the tail's
    ``__call__``, which samples the targets from the ROIs before the PFE."""
    import pcp_tpu.models.detectors.pv_rcnn_plusplus as jax_pp

    rois, scores, labels = _given_rois(np.random.default_rng(14), pair["gt"])
    with jax.enable_x64(True):
        staged, v64 = steps["staged"], steps["v64"]
        tail64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), pp_pair["tail"])
        jt = Staged(pp_pair["jt"], train=True, stages=(None,))
        given = {"rois": jnp.asarray(rois, jnp.float64),
                 "roi_scores": jnp.asarray(scores, jnp.float64),
                 "roi_labels": jnp.asarray(labels)}
        key = jax.random.PRNGKey(SAMPLING_KEY)

        def loss_fn(params, tail_params):
            out = dict(steps["base"], use_given_rois=jnp.asarray(False), batch_size=B)
            stats = v64["batch_stats"]
            for k in (0, 2):
                out, stats = staged.run(k, {"params": params, "batch_stats": stats}, out, key)
            out, tail_stats = jt.run(0, {"params": tail_params,
                                         "batch_stats": tail64["batch_stats"]},
                                     dict(out, **given), key)
            rpn_loss, tb = out["rpn"]
            return rpn_loss + out["loss"], ({**tb, **out["tb_dict"]}, stats, tail_stats,
                                            out["roi_sampling_priorities_jax"])

        with recorded_priorities(jax_pp):
            (loss, (tb, stats, tail_stats, pri)), (grads, tail_grads) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)(v64["params"], tail64["params"])
    merged = _pp_variables({"variables": {"params": _np(grads), "batch_stats": _np(stats)}},
                           {"params": _np(tail_grads), "batch_stats": _np(tail_stats)})
    return {"loss": float(loss), "tb": {k: float(v) for k, v in tb.items()},
            "grads": merged["params"], "stats": merged["batch_stats"],
            "priorities": np.asarray(pri), "rois": (rois, scores, labels)}


def test_pvrcnn_plusplus_weight_bridge_round_trips(pp_pair):
    """The VectorPool leaves land once each in the pcdet-named state dict."""
    flat, tree = jax.tree_util.tree_flatten_with_path(pp_pair["variables"])
    offsets = np.cumsum([0] + [np.size(leaf) for _, leaf in flat])
    labelled = jax.tree_util.tree_unflatten(tree, [
        (np.arange(np.size(leaf), dtype=np.float64) + lo + 1).reshape(np.shape(leaf))
        for (_, leaf), lo in zip(flat, offsets)])
    sd = state_dict_from_jax_variables(labelled, PPCFG)
    assert set(sd) == set(pp_pair["model"].state_dict())
    assert any(".layer_1.separate_local_aggregation_layer" in k for k in sd)
    seen = np.concatenate([t.numpy().ravel() for n, t in sd.items()
                           if not n.endswith("num_batches_tracked")]).astype(np.int64)
    assert np.array_equal(np.sort(seen), np.arange(1, offsets[-1] + 1))


def test_pvrcnn_plusplus_eval_forward_matches_jax(pair, pp_pair):
    jout = pp_pair["jeval"]
    with torch.no_grad():
        tout = pp_pair["model"]({"points": _t(pair["pts"]), "points_mask": _t(pair["mask"])})
    for key in ("point_coords", "point_coords_mask", "roi_valid", "roi_labels"):
        np.testing.assert_array_equal(tout[key].numpy(), jout[key], err_msg=key)
    # SPC: keypoints only near the proposals, fewer valid ones than FPS gives
    assert 0 < jout["point_coords_mask"].sum() and jout["roi_valid"].sum() > 8
    for key, atol in (("point_features", 1e-5), ("point_cls_scores", 1e-5), ("rois", 1e-4),
                      ("batch_cls_preds", 1e-4), ("batch_box_preds", 1e-4)):
        np.testing.assert_allclose(tout[key].numpy(), jout[key], atol=atol, rtol=1e-5, err_msg=key)
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = jout["final_box_dicts"]
    pp = PPCFG["POST_PROCESSING"]
    compared = 0
    for b in range(B):
        compared += match_surviving_boxes(
            {k: v[b] for k, v in got.items()}, {k: v[b] for k, v in want.items()},
            heat_scores=np.zeros(0), top_k=1, score_thresh=pp["SCORE_THRESH"],
            post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"], margin=1e-4, box_atol=1e-4,
            box_rtol=0, score_atol=1e-5, min_matched=1)
    assert compared >= 2


def test_pvrcnn_plusplus_train_step_matches_jax_in_float64(pair, pp_pair, pp_step):
    """On ROIs handed in, sampled before the PFE: the loss and its terms
    within 1e-6 relative (nonzero reg and corner losses), every leaf's
    gradient within 1e-4 of its largest |g|, the statistics within 1e-6."""
    from pcp_tpu_torch.models.roi_heads import pvrcnn_head

    model = copy.deepcopy(pp_pair["model"]).to(torch.float64).train()
    rois, scores, labels = pp_step["rois"]
    batch = {"points": _t(pair["pts"], torch.float64), "points_mask": _t(pair["mask"]),
             "gt_boxes": _t(pair["gt"], torch.float64), "rois": _t(rois, torch.float64),
             "roi_scores": _t(scores, torch.float64), "roi_labels": _t(labels, torch.int64),
             "roi_sampling_priorities": _t(pp_step["priorities"], torch.float64)}
    drawn, orig = [], pvrcnn_head.assign_targets
    pvrcnn_head.assign_targets = lambda *a, **k: drawn.append(orig(*a, **k)) or drawn[-1]
    try:
        out = model(batch)
    finally:
        pvrcnn_head.assign_targets = orig
    out["loss"].backward()
    assert len(drawn) == 1 and int(drawn[0]["reg_valid_mask"].sum()) >= 4
    assert pp_step["tb"]["rcnn_loss_reg"] > 0 and pp_step["tb"]["rcnn_loss_corner"] > 0
    assert out["loss"].item() == pytest.approx(pp_step["loss"], rel=1e-6)
    assert set(out["tb_dict"]) == set(pp_step["tb"])
    for k, v in pp_step["tb"].items():
        assert out["tb_dict"][k].item() == pytest.approx(v, rel=1e-6, abs=1e-9), k
    want = tensors_from_jax_params(pp_step["grads"], PPCFG)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    silent = {n for n, w in want.items() if not w.abs().max().item()}
    assert not silent, silent
    for name, g in got.items():
        w = want[name].double()
        top = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-4 * top, (name, (g - w).abs().max().item(), top)
    state = state_dict_from_jax_variables({"params": pp_pair["variables"]["params"],
                                           "batch_stats": pp_step["stats"]}, PPCFG)
    for name, v in model.state_dict().items():
        if ".running_" in name:
            torch.testing.assert_close(v, state[name].double(), atol=1e-6, rtol=0, msg=name)


def test_pvrcnn_plusplus_trains_and_evaluates_through_the_clis(tmp_path):
    """``entry.PVRCNN_PLUSPLUS`` over the tiny PV-RCNN through the CLIs: its
    PV-RCNN++ modules are the JAX package's test settings (``_ppcfg``)."""
    cfg = _train_and_evaluate_through_the_clis(tmp_path, PVRCNN_PLUSPLUS)
    assert cfg.MODEL.NAME == "PVRCNNPlusPlus" and cfg.MODEL.PFE.SAMPLE_METHOD == "SPC"
    for got, want in ((cfg.MODEL.PFE.SPC_SAMPLING, PP["PFE"]["SPC_SAMPLING"]),
                      (cfg.MODEL.PFE.SA_LAYER.raw_points, PP["PFE"]["SA_LAYER"]["raw_points"]),
                      (cfg.MODEL.ROI_HEAD.ROI_GRID_POOL, PP["ROI_HEAD"]["ROI_GRID_POOL"])):
        assert {k: got[k] for k in want} == want
