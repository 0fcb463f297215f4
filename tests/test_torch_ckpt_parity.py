"""Full-width parity of the port's ego forward with the JAX package, with the
committed trained checkpoint (results/bench_ckpt), b=1 and a few thousand
points (about 40 s on a CPU, most of it the JAX full-grid compile). Run:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ckpt_parity.py -q
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict, cfg_from_yaml_file
from pcp_tpu.models import build_network
from pcp_tpu.models.detectors.detector_template import DatasetInfo
from pcp_tpu.train.checkpoint import load_params_from_file
from pcp_tpu_torch.entry import CFG_EGO, build
from pcp_tpu_torch.utils.box_match import match_surviving_boxes
from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the tier-1 run has six test processes on eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_full_width_forward_matches_with_trained_checkpoint():
    cfg = cfg_from_yaml_file(os.path.join(REPO, CFG_EGO), CfgDict())
    info = DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    jmodel = build_network(cfg.MODEL, num_class=1, dataset_info=info)
    variables = jax.tree_util.tree_map(
        np.asarray, load_params_from_file(os.path.abspath(os.path.join(REPO, "results", "bench_ckpt"))))
    tcfg, _, tmodel = build(CFG_EGO, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax_variables(variables, tcfg.MODEL), strict=True)

    # bench.py's "realistic" occupancy, scaled to 4096 points in 512 pillars
    rng = np.random.default_rng(0)
    n, n_pillars = 4096, 512
    pts = np.zeros((1, n, info.num_point_features), np.float32)
    centers = rng.uniform(-50, 50, size=(1, n_pillars, 2))
    pts[..., 0:2] = centers[:, rng.integers(0, n_pillars, n)] + rng.uniform(-0.1, 0.1, (1, n, 2))
    pts[..., 2] = rng.uniform(-3.0, -0.5, (1, n))
    pts[..., 3] = rng.uniform(0, 1, (1, n))
    mask = np.ones((1, n), bool)

    jout = jmodel.apply(variables, {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
                                    "batch_size": 1}, train=False)
    with torch.inference_mode():
        tout = tmodel({"points": torch.from_numpy(pts), "points_mask": torch.from_numpy(mask)})

    def nhwc(t):
        return t.permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(nhwc(tout["spatial_features"]), np.asarray(jout["spatial_features"]),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(tout["spatial_features_2d"]),
                               np.asarray(jout["spatial_features_2d"]), atol=2e-3, rtol=1e-3)
    for name, t in tout["head_preds"][0].items():
        np.testing.assert_allclose(nhwc(t), np.asarray(jout["head_preds"][0][name]),
                                   atol=3e-3, rtol=1e-3, err_msg=name)
    pp = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    heat = 1 / (1 + np.exp(-np.asarray(jout["head_preds"][0]["hm"], np.float64)))
    got = {k: v[0].numpy() for k, v in tout["final_box_dicts"].items()}
    want = {k: np.asarray(v)[0] for k, v in jout["final_box_dicts"].items()}
    np.testing.assert_array_equal(got["pred_valid"].sum(), want["pred_valid"].sum())
    if want["pred_valid"].any():
        match_surviving_boxes(got, want, heat.reshape(-1), top_k=int(pp.MAX_OBJ_PER_SAMPLE),
                              score_thresh=float(pp.SCORE_THRESH),
                              post_max=int(pp.NMS_CONFIG.NMS_POST_MAXSIZE), min_matched=1)
