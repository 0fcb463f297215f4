"""The anchor-head PointPillar car (``v2x_pointpillar_anchor_car.yaml``):
the port's anchor modules and the whole detector against the JAX package.

Inputs are made from a seed with numpy; tolerances, per test:

* ``generate_anchors``: equal (the same numpy float32 arithmetic).
* ``ResidualCoder`` (plain and sin/cos) and ``PreviousResidualDecoder``:
  encode and decode atol 1e-6 / rtol 1e-6.
* ``boxes3d_nearest_bev_iou``: atol 1e-6, headings on the pi/4 snapping
  boundary among them.
* The axis-aligned assigner over a batch with a gt on an anchor, its
  duplicate (a tie that the first argmax breaks), a small gt between two
  anchors (forced matches, tied), a gt outside the grid (dropped), random
  gts and a sample without any: labels equal, targets and reg weights atol
  1e-5.
* The focal, smooth-L1 and cross-entropy losses: atol 1e-6 / rtol 1e-6.
* The small anchor car with JAX's weights (``build_pair``), the cls bias
  raised so that scores straddle SCORE_THRESH and NMS_PRE_MAXSIZE cuts:
  eval boxes under the margin rule (``utils/box_match.py``); the training
  loss and its tb terms rtol 1e-5; every gradient leaf within 3e-3 of its
  largest |g| (the VFE's through the JAX model's cotangent on the BEV,
  eagerly, as ``tests/test_torch_train.py`` takes it); the running
  statistics atol 1e-6.
* The CLIs: two epochs of the reduced anchor car on the synthetic world
  through ``tools/train.py``, then ``tools/test.py`` on its checkpoint.
* ``ObjectDiscoverer`` (a host model): its fixed-shape predictions equal.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict, cfg_from_yaml_file
from pcp_tpu.models.dense_heads import anchor_head_single as jah
from pcp_tpu.models.loss_fnc import anchor_losses as jlo
from pcp_tpu.models.vfe.dynamic_pillar_vfe import DynamicPillarVFE as JaxVFE
from pcp_tpu.utils import box_coder_utils as jbc
from pcp_tpu.utils.torch_converter import convert_centerpoint_state_dict
from pcp_tpu_torch.models.dense_heads import anchor_head_single as tah
from pcp_tpu_torch.models.loss_fnc import anchor_losses as tlo
from pcp_tpu_torch.ops import bev_scatter
from pcp_tpu_torch.tools import test as test_cli
from pcp_tpu_torch.tools import train as train_cli
from pcp_tpu_torch.utils import box_coder_utils as tbc
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params
from torch_port_helpers import (CAR_FEATURES, MODEL_CFG, B, build_pair, exact_zero_leaves,
                                info_kwargs, jax_batch, load_eval_variables, make_train_batch,
                                torch_batch)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


CFG = "tools/cfgs/v2x_sim_models/v2x_pointpillar_anchor_car.yaml"
YAML = cfg_from_yaml_file(CFG, CfgDict())
HEAD_CFG = copy.deepcopy(dict(YAML.MODEL.DENSE_HEAD))

# the small anchor car: the helpers' VFE and backbone, the config's head;
# NMS_PRE_MAXSIZE under the 2048 anchors of the 32x32 map, so its cut acts
ANCHOR_CFG = copy.deepcopy(MODEL_CFG)
ANCHOR_CFG["NAME"] = "PointPillar"
ANCHOR_CFG["VFE"]["NUM_RAW_POINT_FEATURES"] = 5
ANCHOR_CFG["DENSE_HEAD"] = HEAD_CFG
ANCHOR_CFG["POST_PROCESSING"] = copy.deepcopy(dict(YAML.MODEL.POST_PROCESSING))
ANCHOR_CFG["POST_PROCESSING"]["NMS_CONFIG"].update(NMS_PRE_MAXSIZE=500, NMS_POST_MAXSIZE=100)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _heads(grid=128, head_cfg=HEAD_CFG):
    info = info_kwargs(CAR_FEATURES)
    kw = dict(model_cfg=head_cfg, input_channels=16, num_class=1, class_names=("car",),
              grid_size=(grid, grid, 1), point_cloud_range=info["point_cloud_range"],
              voxel_size=info["voxel_size"])
    return jah.AnchorHeadSingle(**kw), tah.AnchorHeadSingle(**kw)


TWO_SETS = [dict(HEAD_CFG["ANCHOR_GENERATOR_CONFIG"][0]),
            {"class_name": "pedestrian", "anchor_sizes": [[0.8, 0.6, 1.7], [0.6, 0.6, 1.7]],
             "anchor_rotations": [0, 1.57, 3.14], "anchor_bottom_heights": [-0.6],
             "align_center": True, "feature_map_stride": 4, "matched_threshold": 0.5,
             "unmatched_threshold": 0.35}]


@pytest.mark.parametrize("sets,grid", [(HEAD_CFG["ANCHOR_GENERATOR_CONFIG"], 512),
                                       (HEAD_CFG["ANCHOR_GENERATOR_CONFIG"], 128), (TWO_SETS, 96)])
def test_generate_anchors_equal(sets, grid):
    pc = (-51.2, -51.2, -8.0, 51.2, 51.2, 0.0)
    want, want_n = jah.generate_anchors(sets, (grid, grid, 1), pc)
    got, got_n = tah.generate_anchors(sets, (grid, grid, 1), pc)
    assert got_n == want_n and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _boxes(rng, n, extra=0):
    b = np.zeros((n, 7 + extra), np.float32)
    b[:, 0:2] = rng.uniform(-50, 50, (n, 2))
    b[:, 2] = rng.uniform(-3, 1, n)
    b[:, 3:6] = rng.uniform(0.3, 6.0, (n, 3))
    b[:, 6] = rng.uniform(-2 * np.pi, 2 * np.pi, n)
    b[:, 7:] = rng.normal(0, 1, (n, extra))
    return b


@pytest.mark.parametrize("coder,extra", [("plain", 0), ("plain", 2), ("sincos", 0),
                                         ("previous", 0)])
def test_box_coder_matches_jax(coder, extra):
    rng = np.random.default_rng(1)
    boxes, anchors = _boxes(rng, 256, extra), _boxes(rng, 256, extra)
    if coder == "previous":
        jc, tc = jbc.PreviousResidualDecoder(), tbc.PreviousResidualDecoder()
    else:
        sincos = coder == "sincos"
        jc = jbc.ResidualCoder(encode_angle_by_sincos=sincos)
        tc = tbc.ResidualCoder(encode_angle_by_sincos=sincos)
        assert tc.code_size == jc.code_size
        want = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
        got = tc.encode(torch.from_numpy(boxes), torch.from_numpy(anchors)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    enc = rng.normal(0, 0.5, (256, getattr(jc, "code_size", 7) + extra)).astype(np.float32)
    if coder == "sincos":
        anchors = np.concatenate([anchors, np.zeros((256, 1), np.float32)], 1)
    want = np.asarray(jc.decode(jnp.asarray(enc), jnp.asarray(anchors)))
    got = tc.decode(torch.from_numpy(enc), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_nearest_bev_iou_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 200), _boxes(rng, 50)
    a[:, 0:2] = rng.uniform(-5, 5, (200, 2))
    b[:, 0:2] = rng.uniform(-5, 5, (50, 2))
    a[:20, 6] = np.float32(np.pi / 4) * rng.choice([-3, -1, 1, 3], 20)  # on the snapping boundary
    want = np.asarray(jah.boxes3d_nearest_bev_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tah.boxes3d_nearest_bev_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _assigner_gt(rng):
    """(3, 16, 8) gt boxes: sample 0 a gt on an anchor, its duplicate, a
    small gt midway between two anchors, a gt outside the grid, random gts;
    sample 1 random gts; sample 2 none."""
    anchors, _ = jah.generate_anchors(HEAD_CFG["ANCHOR_GENERATOR_CONFIG"], (128, 128, 1),
                                      info_kwargs()["point_cloud_range"])
    gt = np.zeros((3, 16, 8), np.float32)
    on = anchors[10, 12, 0]
    gt[0, 0, :7] = on
    gt[0, 1, :7] = on  # a duplicate: both tie on every anchor, the first wins
    mid = (anchors[20, 5, 0] + anchors[20, 6, 0]) / 2
    gt[0, 2, :7] = [mid[0], mid[1], -1.0, 0.5, 0.5, 1.5, 0.0]  # tied forced matches
    gt[0, 3, :7] = [40.0, 40.0, -1.0, 4.2, 1.8, 1.6, 0.3]  # no overlap: dropped
    for s, lo, hi in ((0, 4, 9), (1, 0, 7)):
        k = hi - lo
        gt[s, lo:hi, 0:2] = rng.uniform(-12, 12, (k, 2))
        gt[s, lo:hi, 2] = -1.0
        gt[s, lo:hi, 3:6] = rng.uniform([3.5, 1.5, 1.4], [4.8, 2.1, 1.8], (k, 3))
        gt[s, lo:hi, 6] = rng.uniform(-np.pi, np.pi, k)
    gt[:2, :9, 7] = np.where(gt[:2, :9, 3] > 0, 1.0, 0.0)
    return gt


def test_assigner_matches_jax():
    jhead, thead = _heads()
    gt = _assigner_gt(np.random.default_rng(3))
    want = _np(jhead.apply({}, jnp.asarray(gt), method=jah.AnchorHeadSingle.assign_targets))
    got = thead.assign_targets(torch.from_numpy(gt))
    labels = got["box_cls_labels"].numpy()
    np.testing.assert_array_equal(labels, want["box_cls_labels"])
    np.testing.assert_allclose(got["box_reg_targets"].numpy(), want["box_reg_targets"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["reg_weights"].numpy(), want["reg_weights"], atol=1e-5, rtol=0)
    # the cases happened: positives and ignored anchors in sample 0, forced
    # matches below the thresholds, nothing positive in sample 2
    iou = tah.boxes3d_nearest_bev_iou(thead.anchors[:, :7], torch.from_numpy(gt[0, 2:3, :7]))[:, 0]
    forced = np.flatnonzero(labels[0] > 0)[np.isin(np.flatnonzero(labels[0] > 0),
                                                    np.flatnonzero(iou.numpy() > 0))]
    assert len(forced) >= 2 and (iou.numpy()[forced] < 0.4).all()
    assert (labels[0] == -1).any() and (labels[1] > 0).any()
    assert (labels[2] == 0).all() and not got["box_reg_targets"][2].any()


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (2, 300, 3)).astype(np.float32)
    target = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 300))]
    target[:, ::5] = 0
    w = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    pred, tgt = rng.normal(0, 1, (2, 300, 7)).astype(np.float32), rng.normal(0, 1, (2, 300, 7)).astype(np.float32)
    tgt[0, :4, 2] = np.nan
    pred[:, :50] = tgt[:, :50] + rng.uniform(-0.1, 0.1, (2, 50, 7)).astype(np.float32)  # under beta
    cw = [1.0, 1.0, 2.0, 1.0, 0.5, 1.0, 1.0]
    cases = [(jlo.sigmoid_focal_cls_loss(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(w)),
              tlo.sigmoid_focal_cls_loss(torch.from_numpy(logits), torch.from_numpy(target),
                                         torch.from_numpy(w))),
             (jlo.weighted_smooth_l1(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(w), code_weights=cw),
              tlo.weighted_smooth_l1(torch.from_numpy(pred), torch.from_numpy(tgt),
                                     torch.from_numpy(w), code_weights=cw)),
             (jlo.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(w)),
              tlo.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(target),
                                         torch.from_numpy(w)))]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- the detector

@pytest.fixture(scope="module")
def pair():
    """The small anchor car in both packages with JAX's weights, the cls
    bias at -1 so that about a third of the anchors score above
    SCORE_THRESH and NMS_PRE_MAXSIZE cuts."""
    jmodel, variables, tmodel = build_pair(seed=11, model_cfg=ANCHOR_CFG, num_features=CAR_FEATURES)
    variables["params"]["dense_head"]["conv_cls"]["bias"] = np.full((2,), -1.0, np.float32)
    load_eval_variables(tmodel, variables, ANCHOR_CFG)
    return jmodel, variables, tmodel


def _car_points(rng, b, n=2000):
    from torch_port_helpers import clustered_points

    return clustered_points(rng, b, n, num_features=CAR_FEATURES)


def test_weight_bridge_round_trip(pair):
    """JAX variables -> the port's state dict -> the JAX package's own
    converter gives them back bit for bit; the port loads them strictly."""
    _, variables, tmodel = pair
    sd = state_dict_from_jax_variables(variables, ANCHOR_CFG)
    assert set(sd) == set(tmodel.state_dict())
    back = convert_centerpoint_state_dict({k: v.numpy() for k, v in sd.items()}, ANCHOR_CFG)
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_eval_boxes_match_jax(pair):
    jmodel, variables, tmodel = pair
    pts = _car_points(np.random.default_rng(12), 2)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, -300:] = False
    jout = jax.jit(lambda p, m: jmodel.apply(variables, {"points": p, "points_mask": m,
                                                         "batch_size": 2}, train=False))(
        jnp.asarray(pts), jnp.asarray(mask))
    with torch.no_grad():
        tout = tmodel({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})
    pp = ANCHOR_CFG["POST_PROCESSING"]
    jcls = np.asarray(jout["batch_cls_preds"])
    np.testing.assert_allclose(tout["batch_cls_preds"].numpy(), jcls, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tout["batch_box_preds"].numpy(), np.asarray(jout["batch_box_preds"]),
                               atol=1e-4, rtol=1e-4)
    for i in range(2):
        heat = 1.0 / (1.0 + np.exp(-jcls[i].astype(np.float64).max(-1)))
        matched = match_surviving_boxes(
            {k: v[i].numpy() for k, v in tout["final_box_dicts"].items()},
            {k: np.asarray(v[i]) for k, v in jout["final_box_dicts"].items()}, heat,
            top_k=pp["NMS_CONFIG"]["NMS_PRE_MAXSIZE"], score_thresh=pp["SCORE_THRESH"],
            post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"])
        assert matched >= 10
        assert (heat > pp["SCORE_THRESH"]).sum() > pp["NMS_CONFIG"]["NMS_PRE_MAXSIZE"]


@pytest.fixture(scope="module")
def one_step(pair):
    """One training forward and backward of the anchor car in both packages."""
    jmodel, variables, tmodel = pair
    rng = np.random.default_rng(13)
    pts, mask, gt = make_train_batch(rng)
    pts = pts[..., :CAR_FEATURES].copy()
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
    info = info_kwargs(CAR_FEATURES)
    jvfe = JaxVFE(model_cfg=ANCHOR_CFG["VFE"], num_point_features=info["num_point_features"],
                  voxel_size=info["voxel_size"], grid_size=info["grid_size"],
                  point_cloud_range=info["point_cloud_range"])

    def vfe_out(params):
        out, _ = jvfe.apply({"params": params, "batch_stats": variables["batch_stats"]["vfe"]}, jb,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out["pillar_features"] * cotangent)

    jgrads = dict(_np(jgrads), vfe=_np(jax.grad(vfe_out)(variables["params"]["vfe"])))  # eager
    model = copy.deepcopy(tmodel).train()
    out = model(torch_batch(pts, mask, gt))
    out["loss"].backward()
    return {"jax": {"loss": float(jloss), "tb": {k: float(v) for k, v in jtb.items()},
                    "grads": tensors_from_jax_params(jgrads, ANCHOR_CFG),
                    "state": state_dict_from_jax_variables(
                        {"params": variables["params"], "batch_stats": _np(jstats)}, ANCHOR_CFG)},
            "torch": {"loss": out["loss"].item(),
                      "tb": {k: v.item() for k, v in out["tb_dict"].items()},
                      "grads": {n: p.grad for n, p in model.named_parameters()},
                      "state": model.state_dict()},
            "model": model}


def test_train_loss_and_tb_match_jax(one_step):
    j, t = one_step["jax"], one_step["torch"]
    assert set(t["tb"]) == set(j["tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir",
                                            "rpn_loss", "loss_rpn"}
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    for key, value in j["tb"].items():
        assert t["tb"][key] == pytest.approx(value, rel=1e-5), key


@pytest.mark.parametrize("group", ("vfe", "backbone_2d", "dense_head"))
def test_train_gradients_and_statistics_match_jax(one_step, group):
    want, got = one_step["jax"]["grads"], one_step["torch"]["grads"]
    names = [n for n in got if n.startswith(group + ".")]
    assert names and set(names) == {n for n in want if n.startswith(group + ".")}
    top = max(v.abs().max().item() for v in want.values())
    zero = exact_zero_leaves(one_step["model"])
    for name in names:
        g, w = got[name], want[name]
        if name in zero:
            assert g.abs().max().item() <= 1e-6 * top and w.abs().max().item() <= 1e-6 * top, name
            continue
        err = (g - w).abs().max().item()
        assert err <= 3e-3 * w.abs().max().item(), (name, err, w.abs().max().item())
    for name in (n for n in one_step["torch"]["state"] if n.startswith(group + ".")
                 and ".running_" in n):
        torch.testing.assert_close(one_step["torch"]["state"][name],
                                   one_step["jax"]["state"][name], atol=1e-6, rtol=0, msg=name)


# ------------------------------------------------------------------ the CLIs

# the anchor car at the helpers' reduced size on a tiny synthetic world
REDUCED = ["MODEL.VFE.NUM_FILTERS", "[16, 16]", "MODEL.MAP_TO_BEV.NUM_BEV_FEATURES", "16",
           "MODEL.BACKBONE_2D.LAYER_NUMS", "[1, 1, 1]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16, 32, 32]",
           "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16, 16, 16]",
           "MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE", "500",
           "DATA_CONFIG.POINT_CLOUD_RANGE", "[-12.8, -12.8, -8.0, 12.8, 12.8, 0.0]",
           "DATA_CONFIG.USE_SYNTHETIC_DATA", "True", "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "2048",
           "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1", "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1",
           "DATA_CONFIG.SYNTHETIC", "{'NUM_SCENES': 2, 'KEYFRAMES_PER_SCENE': 2, 'NUM_CARS': 6, "
           "'NUM_PEDS': 0, 'WORLD': 'urban'}"]


def test_cli_trains_and_evaluates(tmp_path):
    """Two epochs through the train CLI, then the test CLI on the last
    checkpoint: finite losses and metrics, no kernel launched on the CPU."""
    common = ["--cfg_file", CFG, "--batch_size", "2", "--workers", "0", "--device", "cpu",
              "--extra_tag", "anchor", "--output_root", str(tmp_path)]
    out = train_cli.main([*common, "--epochs", "2", "--num_epochs_to_eval", "0",
                          "--precise_bn", "0", "--seed", "1", "--set", *REDUCED])
    assert out["steps"] > 0 and np.isfinite(out["losses"]).all()
    assert not any(out["launches"].values())
    ckpt = (tmp_path / "cfgs/v2x_sim_models/v2x_pointpillar_anchor_car/anchor/ckpt"
            / "checkpoint_epoch_2.pth")
    bev_scatter.reset_launches()
    metrics = test_cli.main([*common, "--ckpt", str(ckpt), "--set", *REDUCED])
    assert np.isfinite(metrics["mAP"]) and np.isfinite(metrics["recall/rcnn_0.3"])


def test_object_discoverer_matches_jax():
    """The eval-only host model: each cloud's discovered boxes as
    fixed-shape predictions with unit scores and 1-based labels, capped at
    MAX_OBJ_PER_SAMPLE; equal to the JAX package's."""
    from pcp_tpu.models.detectors.obj_discoverer import ObjectDiscoverer as JaxDiscoverer
    from pcp_tpu_torch.models.detectors import build_detector

    rng = np.random.default_rng(9)
    cfg = {"NAME": "ObjectDiscoverer", "POST_PROCESSING": {"MAX_OBJ_PER_SAMPLE": 6}}
    metas = [{"disco_boxes": np.concatenate([rng.normal(0, 5, (n, 9)),
                                             rng.integers(0, 3, (n, 1))], 1).astype(np.float32)}
             for n in (4, 9, 0)]
    metas.append({})
    batch = {"batch_size": len(metas), "metadata": metas}
    want = JaxDiscoverer(model_cfg=cfg, num_class=3, dataset_info=None)(batch)["final_box_dicts"]
    model = build_detector(cfg, num_class=3, dataset_info=None)
    assert model.is_host_model
    got = model(batch)["final_box_dicts"]
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert got["pred_valid"].sum(1).tolist() == [4, 6, 0, 0]
