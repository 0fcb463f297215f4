"""The port's ego CenterPoint forward against the JAX package, end to end.

The ego config's structure at reduced size (tests/torch_port_helpers.py),
the same weights in both packages, the same points. Tolerances are those of
tests/test_full_model_parity.py: BEV 2e-4/1e-4, backbone 2e-3/1e-3, head
3e-3/1e-3, and surviving boxes under the margin rule.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu_torch.ops import bev_scatter
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from torch_port_helpers import MODEL_CFG, build_pair, clustered_points


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _forward_pair(model_cfg=None):
    rng = np.random.default_rng(11)
    pts = clustered_points(rng, 2, 3000)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, -300:] = False  # padding rows
    jmodel, variables, tmodel = build_pair(seed=3, model_cfg=model_cfg)
    jout = jmodel.apply(variables, {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
                                    "batch_size": 2}, train=False)
    with torch.inference_mode():
        tout = tmodel({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})
    return jout, tout


@pytest.fixture(scope="module")
def outputs():
    return _forward_pair()


@pytest.fixture(scope="module")
def outputs_fused():
    """The same models and points with ``PRE_REDUCE: fused`` in both packages."""
    cfg = copy.deepcopy(MODEL_CFG)
    cfg["VFE"]["PRE_REDUCE"] = "fused"
    return _forward_pair(cfg)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_bev_and_backbone_match(outputs):
    jout, tout = outputs
    np.testing.assert_allclose(_nhwc(tout["spatial_features"]),
                               np.asarray(jout["spatial_features"]), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(_nhwc(tout["spatial_features_2d"]),
                               np.asarray(jout["spatial_features_2d"]), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("branch", ["hm", "center", "center_z", "dim", "rot"])
def test_head_branch_matches(outputs, branch):
    jout, tout = outputs
    np.testing.assert_allclose(_nhwc(tout["head_preds"][0][branch]),
                               np.asarray(jout["head_preds"][0][branch]), atol=3e-3, rtol=1e-3)


def test_final_boxes_match(outputs):
    jout, tout = outputs
    pp = MODEL_CFG["DENSE_HEAD"]["POST_PROCESSING"]
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = {k: np.asarray(v) for k, v in jout["final_box_dicts"].items()}
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert got["pred_boxes"].shape == (2, 83, 7)
    heat = 1 / (1 + np.exp(-np.asarray(jout["head_preds"][0]["hm"], np.float64)))
    for i in range(2):
        match_surviving_boxes({k: v[i] for k, v in got.items()},
                              {k: v[i] for k, v in want.items()},
                              heat[i].reshape(-1), top_k=pp["MAX_OBJ_PER_SAMPLE"],
                              score_thresh=pp["SCORE_THRESH"],
                              post_max=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"])
    np.testing.assert_array_equal(got["pred_labels"][got["pred_valid"]], 1)


def test_cpu_forward_launches_no_kernel(outputs, outputs_fused):
    assert not any(bev_scatter.launches.values())


def test_fused_bev_and_backbone_match(outputs_fused):
    test_bev_and_backbone_match(outputs_fused)


@pytest.mark.parametrize("branch", ["hm", "center", "center_z", "dim", "rot"])
def test_fused_head_branch_matches(outputs_fused, branch):
    test_head_branch_matches(outputs_fused, branch)


def test_fused_final_boxes_match(outputs_fused):
    test_final_boxes_match(outputs_fused)


def test_fused_equals_default_in_the_port(outputs, outputs_fused):
    """A max does no rounding: the fused path gives the default path's BEV
    and boxes exactly."""
    for key in ("spatial_features", "spatial_features_2d"):
        assert torch.equal(outputs[1][key], outputs_fused[1][key]), key
    for key, value in outputs[1]["final_box_dicts"].items():
        assert torch.equal(value, outputs_fused[1]["final_box_dicts"][key]), key


@pytest.mark.parametrize("num_class", [1, 3])
def test_decode_matches_jax_with_ties(num_class):
    """Top-k decode, single-class sort path and multi-class two-stage top-k,
    on heatmaps with many exactly equal scores (ties go to the lower index)."""
    from pcp_tpu.models.model_utils.centernet_utils import decode_bbox_from_heatmap as jax_decode
    from pcp_tpu_torch.models.model_utils.centernet_utils import decode_bbox_from_heatmap

    rng = np.random.default_rng(num_class)
    b, h, w = 2, 16, 16
    heat = np.round(rng.uniform(0, 1, (b, h, w, num_class)), 1).astype(np.float32)  # ties
    fields = {"rot_cos": rng.normal(size=(b, h, w, 1)), "rot_sin": rng.normal(size=(b, h, w, 1)),
              "center": rng.uniform(0, 1, (b, h, w, 2)), "center_z": rng.normal(size=(b, h, w, 1)),
              "dim": rng.uniform(0.5, 3, (b, h, w, 3))}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    kw = dict(point_cloud_range=(-12.8, -12.8, -8.0, 12.8, 12.8, 0.0), voxel_size=(0.2, 0.2, 8.0),
              feature_map_stride=4, k=100, score_thresh=0.3,
              post_center_limit_range=[-10.0, -10.0, -10.0, 10.0, 10.0, 10.0])
    want = jax_decode(heatmap=jnp.asarray(heat), **{k: jnp.asarray(v) for k, v in fields.items()},
                      **kw)
    got = decode_bbox_from_heatmap(heatmap=torch.from_numpy(heat),
                                   **{k: torch.from_numpy(v) for k, v in fields.items()}, **kw)
    for key in ("pred_scores", "pred_labels", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]),
                               atol=1e-5, rtol=1e-6)
