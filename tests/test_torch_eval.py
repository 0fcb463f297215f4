"""The port's evaluation against the JAX package's.

* ``boxes_iou3d`` against the JAX one at atol 1e-5 (random pairs, identical
  and touching boxes, batch dimensions);
* ``eval_one_epoch`` of both packages on the car sender reduced by the
  ``--set`` pairs of ``REDUCED`` (two layers a backbone level, narrow widths,
  a 128x128 grid at a 0.8 m voxel, the HunterJr corrector kept) with the JAX
  package's seeded variables (random BN statistics, the heatmap's output
  bias raised by 1.5) carried across by ``utils/jax_weights.py``
  (``torch_port_helpers.load_eval_variables``), over the same tiny val set
  read in order (the points unshuffled). The final boxes must agree under
  the margin rule of ``tests/test_full_model_parity.py`` (boxes whose score
  lies within 5e-4 of the score threshold may differ; the others match 1-1
  within atol 5e-3 / rtol 2e-3), and where no box of either side lies
  within the margin the recall counts must be equal and the numeric
  results (``metrics.json``) equal to 1e-6, the timing keys aside.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import cfg_from_list as jax_cfg_from_list
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.datasets import build_dataloader as jax_build_dataloader
from pcp_tpu.models import build_network as jax_build_network
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.ops.rotated_iou import boxes_iou3d as jax_boxes_iou3d
from pcp_tpu.train.eval_utils import eval_one_epoch as jax_eval_one_epoch
from pcp_tpu_torch.config import CfgDict, cfg_from_list, cfg_from_yaml_file
from pcp_tpu_torch.datasets import build_dataloader
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.ops.rotated_iou import boxes_iou3d
from pcp_tpu_torch.tools.test import write_metrics
from pcp_tpu_torch.train.eval_utils import eval_one_epoch
from torch_port_helpers import load_eval_variables, randomize_batch_stats

CFG_CAR = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml"
SYN = ("{'NUM_SCENES': 3, 'KEYFRAMES_PER_SCENE': 2, 'NUM_CARS': 10, 'NUM_PEDS': 2, "
       "'WORLD': 'urban', 'NUM_PARKED': 4, 'VISIBLE_FACES': True}")
PROCESSOR = ("[{'NAME': 'mask_points_and_boxes_outside_range', 'REMOVE_OUTSIDE_BOXES': False}, "
             "{'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {'train': True, 'test': False}}, "
             "{'NAME': 'transform_points_to_voxels_placeholder', 'VOXEL_SIZE': [0.8, 0.8, 8.0]}]")
# the --set pairs of the reduced car sender and its tiny synthetic world
REDUCED = ["DATA_CONFIG.USE_SYNTHETIC_DATA", "True", "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "4096",
           "DATA_CONFIG.SYNTHETIC", SYN, "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1",
           "DATA_CONFIG.DATA_PROCESSOR", PROCESSOR,
           "MODEL.VFE.NUM_FILTERS", "[16, 16]", "MODEL.MAP_TO_BEV.NUM_BEV_FEATURES", "16",
           "MODEL.BACKBONE_2D.LAYER_NUMS", "[2, 2, 2]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16, 32, 32]",
           "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16, 16, 16]",
           "MODEL.DENSE_HEAD.SHARED_CONV_CHANNEL", "16",
           "MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE", "4096",
           "MODEL.CORRECTOR.POINT_HEAD_HIDDEN_CHANNELS", "[8]",
           "MODEL.CORRECTOR.OBJ_HEAD_HIDDEN_CHANNELS", "[8]"]
MARGIN = 5e-4
TIMING_KEYS = ("sec_per_example", "infer_time_ms_per_batch")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-6, 6, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


def test_boxes_iou3d_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[:5] = a[:5]  # identical pairs
    b[5:8] = a[5:8] + np.float32([0, 0, 0.5, 0, 0, 0, 0]) * a[5:8, 5:6]  # touching in z
    want = np.asarray(jax_boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    got = boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0.1).sum() > 10
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    batched = boxes_iou3d(torch.from_numpy(np.stack([a, a])), torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched[1].numpy(), got)


def _cfgs():
    jcfg = jax_cfg_from_yaml(CFG_CAR, JaxCfg())
    jax_cfg_from_list(list(REDUCED), jcfg)
    tcfg = cfg_from_yaml_file(CFG_CAR, CfgDict())
    cfg_from_list(list(REDUCED), tcfg)
    return jcfg, tcfg


def _kept(anno, thresh):
    keep = anno["score"] > thresh + MARGIN
    return anno["boxes_lidar"][keep], anno["score"][keep]


@pytest.fixture(scope="module")
def both_evals(tmp_path_factory):
    import jax

    jcfg, tcfg = _cfgs()
    jinfo = JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    jmodel = jax_build_network(jcfg.MODEL, num_class=1, dataset_info=jinfo)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                           training=False, workers=0)
    tds, tloader, _ = build_dataloader(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, batch_size=2,
                                       training=False, workers=0)
    example = next(iter(jloader))
    init = jax.jit(lambda key, p, m: jmodel.init(
        key, {"points": p, "points_mask": m, "batch_size": p.shape[0]}, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(example["points"]), jnp.asarray(example["points_mask"]))
    rng = np.random.default_rng(0)
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"], rng)}
    # heatmap scores about 0.3 in place of the initial 0.1, the score
    # threshold: boxes then survive it, most of them far from it
    hm_out = variables["params"]["dense_head"]["head_0"]["hm_out"]
    hm_out["bias"] = hm_out["bias"] + np.float32(1.5)
    tmodel = build_network(tcfg.MODEL, num_class=1,
                           dataset_info=DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"]),
                           device="cpu")
    load_eval_variables(tmodel, variables, tcfg.MODEL)

    thresh = tcfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST
    _, jres, jannos = jax_eval_one_epoch(jmodel, variables, jds, jloader, ["car"],
                                         recall_thresh_list=thresh)
    tdir = tmp_path_factory.mktemp("eval")
    _, tres, tannos = eval_one_epoch(tmodel, tds, tloader, ["car"], recall_thresh_list=thresh,
                                     output_path=tdir)
    return tcfg, jres, jannos, tres, tannos, tdir


def test_eval_one_epoch_boxes_match_jax(both_evals):
    tcfg, _, jannos, _, tannos, _ = both_evals
    thresh = tcfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH
    assert len(jannos) == len(tannos) > 0
    compared = 0
    for ja, ta in zip(jannos, tannos):
        assert ja["metadata"]["lidar_token"] == ta["metadata"]["lidar_token"]
        wo, ws = _kept(ja, thresh)
        go, gs = _kept(ta, thresh)
        assert len(wo) == len(go), (ws, gs)
        if not len(wo):
            continue
        dist = np.linalg.norm(go[:, None, :3] - wo[None, :, :3], axis=-1)
        match = np.argmin(dist, axis=1)
        assert len(set(match.tolist())) == len(match), "matching not 1-1"
        np.testing.assert_allclose(go, wo[match], atol=5e-3, rtol=2e-3)
        np.testing.assert_allclose(gs, ws[match], atol=1e-4, rtol=1e-4)
        compared += len(wo)
    assert compared >= 3, "vacuous comparison"


def test_eval_one_epoch_metrics_match_jax(both_evals):
    tcfg, jres, jannos, tres, tannos, tdir = both_evals
    thresh = tcfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH
    near = [a["score"][(a["score"] > thresh) & (a["score"] <= thresh + MARGIN)]
            for a in jannos + tannos]
    if sum(len(s) for s in near):
        pytest.fail(f"a box lies within the margin of the score threshold: {near}; "
                    "choose other seeded weights for a comparison of the metrics")
    want = {k: float(v) for k, v in jres.items()
            if isinstance(v, (int, float, np.floating, np.integer))}
    got = write_metrics(tres, tdir)
    assert json.loads((tdir / "metrics.json").read_text()) == got
    assert (tdir / "metrics_summary.json").exists()
    assert set(got) == set(want)
    for key in want:
        if key not in TIMING_KEYS:
            assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    for th in tcfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST:
        assert tres[f"recall/rcnn_{th}"] == jres[f"recall/rcnn_{th}"]
