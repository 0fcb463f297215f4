"""The port's fusion baselines against the JAX package's, on a tiny
synthetic world.

* ``weighted_nms_bev_np`` and ``nms_bev_np`` on random boxes with tied
  scores: equal kept indices, fused boxes within 1e-12;
* the early-fusion dataset item for item (sync, async, current-only; train
  and test), exactly, and the collated batch;
* the late-fusion dataset item for item on an exchange database that the
  JAX package's writer filled (now, prev, prev without flow, prev with
  oracle flow), exactly;
* ``V2XLateFusion`` under ``nms``, ``weighted_nms`` and ``ego_only`` on the
  collated late batches: equal outputs;
* the early ego at small width (two layers a level, narrow widths, a
  128x128 grid) on one collated early batch, from the JAX package's seeded
  variables: the final boxes under the margin rule of
  ``test_torch_eval.py``;
* a late-fusion evaluation through the port's ``tools/test.py`` with no
  checkpoint against the JAX package's ``eval_one_epoch`` of its late
  fusion on the same database: every numeric result within 1e-6;
* the early config trains through the port's ``tools/train.py``; what is
  still not ported (A11's datasets and MODEL keys) raises naming A11
  (DiscoNet, once refused here naming A9, has its own tests in
  ``test_torch_disconet.py``).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import cfg_from_list as jax_cfg_from_list
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.datasets import build_dataloader as jax_build_dataloader
from pcp_tpu.exchange import ExchangeDatabase as JaxExchangeDatabase
from pcp_tpu.exchange.database import pool_box_flow
from pcp_tpu.models import build_network as jax_build_network
from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
from pcp_tpu.models.detectors.v2x_late_fusion import V2XLateFusion as JaxLateFusion
from pcp_tpu.train.eval_utils import eval_one_epoch as jax_eval_one_epoch
from pcp_tpu.utils.nms_np import nms_bev_np as jax_nms_bev_np
from pcp_tpu.utils.nms_np import weighted_nms_bev_np as jax_weighted_nms_bev_np
from pcp_tpu_torch.config import CfgDict, cfg_from_list, cfg_from_yaml_file
from pcp_tpu_torch.datasets import build_dataloader
from pcp_tpu_torch.models import DatasetInfo, build_network
from pcp_tpu_torch.models.detectors.v2x_late_fusion import V2XLateFusion
from pcp_tpu_torch.tools import test as test_cli
from pcp_tpu_torch.tools import train as train_cli
from pcp_tpu_torch.utils.nms_np import nms_bev_np, weighted_nms_bev_np
from test_torch_datasets import SYN, _two_threads, assert_same, cfg_pair  # noqa: F401
from test_torch_eval import MARGIN, TIMING_KEYS, _kept
from torch_port_helpers import load_eval_variables, randomize_batch_stats

CFGS = "tools/cfgs/v2x_sim_models"
LATE_CFG = f"{CFGS}/v2x_late_fusion.yaml"
EARLY_CFG = f"{CFGS}/v2x_pointpillar_basic_ego_early.yaml"
PROCESSOR = ("[{'NAME': 'mask_points_and_boxes_outside_range', 'REMOVE_OUTSIDE_BOXES': False}, "
             "{'NAME': 'shuffle_points', 'SHUFFLE_ENABLED': {'train': True, 'test': False}}, "
             "{'NAME': 'transform_points_to_voxels_placeholder', 'VOXEL_SIZE': [0.8, 0.8, 8.0]}]")
# the early ego reduced: a 0.8 m voxel (128x128 grid), two layers a level, narrow widths
EARLY_REDUCED = ["DATA_CONFIG.DATA_PROCESSOR", PROCESSOR,
                 "MODEL.VFE.NUM_FILTERS", "[16, 16]", "MODEL.MAP_TO_BEV.NUM_BEV_FEATURES", "16",
                 "MODEL.BACKBONE_2D.LAYER_NUMS", "[2, 2, 2]",
                 "MODEL.BACKBONE_2D.NUM_FILTERS", "[16, 32, 32]",
                 "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16, 16, 16]",
                 "MODEL.DENSE_HEAD.SHARED_CONV_CHANNEL", "16"]


def _world(max_points=4096):
    return ["DATA_CONFIG.USE_SYNTHETIC_DATA", "True", "DATA_CONFIG.SYNTHETIC", repr(SYN),
            "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", str(max_points),
            "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1", "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1"]


def _model_cfgs(path, sets):
    jcfg = jax_cfg_from_yaml(path, JaxCfg())
    jax_cfg_from_list(list(sets), jcfg)
    tcfg = cfg_from_yaml_file(path, CfgDict())
    cfg_from_list(list(sets), tcfg)
    return jcfg, tcfg


def _both_datasets(jcfg, tcfg, training, seed=7):
    jds, _, _ = jax_build_dataloader(jcfg, ["car"], batch_size=2, training=training, workers=0)
    tds, _, _ = build_dataloader(tcfg, ["car"], batch_size=2, training=training, workers=0)
    np.random.seed(seed)
    tds.rng = np.random.RandomState(seed)
    return jds, tds


def _items(ds):
    return [ds[i] for i in range(len(ds))]


# ------------------------------------------------------------------ NMS

def _tied_boxes(rng, n):
    """Boxes on a 12 m square, many overlapping, about half of them with a
    score shared by another."""
    boxes = np.concatenate([rng.uniform(-6, 6, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                            rng.uniform(1.5, 5, (n, 2)), rng.uniform(1, 2, (n, 1)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    scores = rng.choice(np.round(rng.uniform(0.1, 1.0, n // 2), 2), n)
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_nms_matches_jax(seed):
    boxes, scores = _tied_boxes(np.random.default_rng(seed), 60)
    assert len(np.unique(scores)) < len(scores)
    for thresh in (0.1, 0.3):
        want_fused, want_keep = jax_weighted_nms_bev_np(boxes, scores, thresh)
        got_fused, got_keep = weighted_nms_bev_np(boxes, scores, thresh)
        np.testing.assert_array_equal(got_keep, want_keep)
        assert len(want_keep) < len(boxes)
        np.testing.assert_allclose(got_fused, want_fused, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(nms_bev_np(boxes, scores, thresh),
                                      jax_nms_bev_np(boxes, scores, thresh))
    fused, keep = weighted_nms_bev_np(np.zeros((0, 7)), np.zeros(0), 0.3)
    assert fused.shape == (0, 7) and keep.shape == (0,)


# ------------------------------------------------------------ early data

EARLY = {"sync": {"EXCHANGE_PREVIOUS": False}, "async": {"EXCHANGE_PREVIOUS": True},
         "current_only": {"EXCHANGE_PREVIOUS": True, "EXCHANGE_CURRENT_ONLY": True}}


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("setting", list(EARLY))
def test_early_items_equal_jax(setting, training):
    jcfg, tcfg = cfg_pair("v2x_sim_dataset_ego_early", **EARLY[setting])
    jds, tds = _both_datasets(jcfg, tcfg, training)
    assert len(jds) == len(tds) > 0
    assert [i["lidar_token"] for i in jds.infos] == [i["lidar_token"] for i in tds.infos]
    jitems, titems = _items(jds), _items(tds)
    for a, b in zip(jitems, titems):
        assert_same(a, b)
    exchanged = sum(v for t in titems for v in t["metadata"]["exchange"].values())
    assert exchanged > 0, "no exchanged point reached the ego"
    assert_same(jds.collate_batch(jitems[:3]), tds.collate_batch(titems[:3]))
    if setting != "sync":  # a sample without a previous keyframe is dropped
        jsync, tsync = cfg_pair("v2x_sim_dataset_ego_early")
        assert len(tds) < len(_both_datasets(jsync, tsync, training)[1])


# ------------------------------------------------------------- late data

@pytest.fixture(scope="module")
def late_db(tmp_path_factory):
    """An exchange database written by the JAX package's writer: for every
    keyframe and lidar (the ego's too) the sender's car gt jittered, with a
    score and label 1, its foreground points with flow, and the boxflow."""
    from pcp_tpu.datasets.v2x_sim.source import SyntheticV2XSource as JaxSource

    root = tmp_path_factory.mktemp("late_db")
    rng = np.random.default_rng(21)
    src = JaxSource(num_scenes=3, keyframes_per_scene=3, num_cars=8, num_peds=2, world="urban",
                    num_parked=4, visible_faces=True)
    db = JaxExchangeDatabase(root)
    for scene, kf in src.iter_samples():
        token = src.sample_token(scene, kf)
        for lid in range(6):
            boxes = src.get_frame(src.lidar_token(scene, kf, lid),
                                  classes_of_interest=("car",))["boxes"]
            if boxes.shape[0] == 0:
                continue
            modar = np.zeros((boxes.shape[0], 9), np.float32)
            modar[:, :7] = boxes + rng.normal(0, 0.15, boxes.shape)
            modar[:, 7] = np.round(rng.uniform(0.05, 1.0, boxes.shape[0]), 2)
            modar[:, 8] = 1.0
            fg = np.zeros((4 * boxes.shape[0], 13), np.float32)
            fg[:, :3] = np.repeat(boxes[:, :3], 4, axis=0) + rng.uniform(-0.3, 0.3, (len(fg), 3))
            fg[:, 7:10] = rng.dirichlet(np.ones(3), len(fg))
            fg[:, 10:13] = rng.normal(0, 0.5, (len(fg), 3))
            db.save_modar(token, lid, modar)
            db.save_foreground(token, lid, fg)
            db.save_boxflow(token, lid, pool_box_flow(modar, fg))
    return root


LATE = {"now": {"EXCHANGE_SETTING": "now"}, "prev": {"EXCHANGE_SETTING": "prev"},
        "prev_noflow": {"EXCHANGE_SETTING": "prev", "EXCHANGE_FLOW_PROPAGATION": False},
        "prev_oracle_flow": {"EXCHANGE_SETTING": "prev", "EXCHANGE_ORACLE_FLOW": True}}


def _late_datasets(late_db, setting):
    jcfg, tcfg = cfg_pair("v2x_sim_dataset_ego_late", EXCHANGE_DATABASE_DIRECTORY=str(late_db),
                          EVAL_FILTER_GT_BEYOND_RANGE=60.0, **LATE[setting])
    return _both_datasets(jcfg, tcfg, training=False)


@pytest.mark.parametrize("setting", list(LATE))
def test_late_items_and_fusion_equal_jax(setting, late_db):
    jds, tds = _late_datasets(late_db, setting)
    jitems, titems = _items(jds), _items(tds)
    for a, b in zip(jitems, titems):
        assert_same(a, b)
    boxes = [t["metadata"]["exchange_boxes"] for t in titems]
    assert sum(v.shape[0] for d in boxes for k, v in d.items() if k != 1) > 0
    jcfg, tcfg = _model_cfgs(LATE_CFG, [])
    for method in ("nms", "weighted_nms", "ego_only"):
        jcfg.MODEL.BOX_FUSION_METHOD = tcfg.MODEL.BOX_FUSION_METHOD = method
        jmodel = JaxLateFusion(jcfg.MODEL, 1, None)
        tmodel = build_network(tcfg.MODEL, 1, None, device="cpu")
        assert isinstance(tmodel, V2XLateFusion)
        kept = 0
        for start in range(0, len(titems), 4):
            want = jmodel(jds.collate_batch(jitems[start:start + 4]))["final_box_dicts"]
            got = tmodel(tds.collate_batch(titems[start:start + 4]))["final_box_dicts"]
            assert_same({k: np.asarray(v) for k, v in want.items()}, got, method)
            kept += int(got["pred_valid"].sum())
        assert kept > 0, method


# ---------------------------------------------------------- early model

def test_early_ego_forward_matches_jax():
    jcfg, tcfg = _model_cfgs(EARLY_CFG, _world() + EARLY_REDUCED)
    _, tds = _both_datasets(jcfg.DATA_CONFIG, tcfg.DATA_CONFIG, training=False)
    batch = tds.collate_batch([tds[i] for i in range(2)])
    assert batch["points_mask"].sum() > 4096  # the merged clouds overflow one ego's share
    jinfo = JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    jmodel = jax_build_network(jcfg.MODEL, num_class=1, dataset_info=jinfo)
    pts, mask = jnp.asarray(batch["points"]), jnp.asarray(batch["points_mask"])
    jbatch = {"points": pts, "points_mask": mask, "batch_size": 2}
    init = jax.jit(lambda key: jmodel.init(key, jbatch, train=False))(jax.random.PRNGKey(3))
    variables = {"params": jax.tree_util.tree_map(np.asarray, init["params"]),
                 "batch_stats": randomize_batch_stats(init["batch_stats"],
                                                      np.random.default_rng(3))}
    hm_out = variables["params"]["dense_head"]["head_0"]["hm_out"]
    hm_out["bias"] = hm_out["bias"] + np.float32(1.5)
    want = jax.jit(lambda v: jmodel.apply(v, jbatch, train=False)["final_box_dicts"])(variables)
    tmodel = build_network(tcfg.MODEL, 1, DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"]),
                           device="cpu")
    load_eval_variables(tmodel, variables, tcfg.MODEL)
    with torch.no_grad():
        got = tmodel({"points": torch.from_numpy(batch["points"]),
                      "points_mask": torch.from_numpy(batch["points_mask"])})["final_box_dicts"]
    thresh = tcfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH
    compared = 0
    for i in range(2):
        ja = {"boxes_lidar": np.asarray(want["pred_boxes"][i])[np.asarray(want["pred_valid"][i])],
              "score": np.asarray(want["pred_scores"][i])[np.asarray(want["pred_valid"][i])]}
        ta = {"boxes_lidar": got["pred_boxes"][i][got["pred_valid"][i]].numpy(),
              "score": got["pred_scores"][i][got["pred_valid"][i]].numpy()}
        wo, ws = _kept(ja, thresh)
        go, gs = _kept(ta, thresh)
        assert len(wo) == len(go), (ws, gs)
        if not len(wo):
            continue
        match = np.argmin(np.linalg.norm(go[:, None, :3] - wo[None, :, :3], axis=-1), axis=1)
        assert len(set(match.tolist())) == len(match), "matching not 1-1"
        np.testing.assert_allclose(go, wo[match], atol=5e-3, rtol=2e-3)
        np.testing.assert_allclose(gs, ws[match], atol=1e-4, rtol=1e-4)
        compared += len(wo)
    assert compared >= 3, "vacuous comparison"


# ---------------------------------------------------------------- CLIs

def test_late_eval_cli_without_checkpoint_matches_jax(late_db, tmp_path):
    sets = _world() + ["DATA_CONFIG.EXCHANGE_DATABASE_DIRECTORY", str(late_db),
                       "DATA_CONFIG.EXCHANGE_SETTING", "prev",
                       "MODEL.BOX_FUSION_METHOD", "weighted_nms"]
    got = test_cli.main(["--cfg_file", LATE_CFG, "--batch_size", "4", "--workers", "0",
                         "--device", "cpu", "--extra_tag", "late", "--eval_tag", "late_async_wnms",
                         "--output_root", str(tmp_path), "--set", *sets])
    eval_dir = tmp_path / "cfgs/v2x_sim_models/v2x_late_fusion/late/eval/late_async_wnms"
    metrics = json.loads((eval_dir / "metrics.json").read_text())
    jcfg, _ = _model_cfgs(LATE_CFG, sets)
    jds, jloader, _ = jax_build_dataloader(jcfg.DATA_CONFIG, ["car"], batch_size=4,
                                           training=False, workers=0)
    _, want, _ = jax_eval_one_epoch(JaxLateFusion(jcfg.MODEL, 1, None), None, jds, jloader,
                                    ["car"], recall_thresh_list=[0.3, 0.5, 0.7])
    want = {k: float(v) for k, v in want.items()
            if isinstance(v, (int, float, np.floating, np.integer))}
    assert set(metrics) == set(want)
    assert metrics["mAP"] == got["mAP"] and 0.0 < metrics["mAP"]
    for key in set(want) - set(TIMING_KEYS):
        assert abs(metrics[key] - want[key]) <= 1e-6, (key, metrics[key], want[key])


def test_early_config_trains_and_disco_raises(tmp_path):
    """One epoch of the reduced early ego through the train CLI on the CPU;
    a config with a MODEL module that is still not ported (A11.6: the
    SECOND ego with PartA2's UNetV2 as its 3D backbone) refuses, naming
    A11; KITTI, ported, refuses a data path without its infos, naming the
    command that builds them."""
    argv = ["--batch_size", "2", "--workers", "0", "--device", "cpu", "--extra_tag", "early",
            "--output_root", str(tmp_path), "--num_epochs_to_eval", "0", "--precise_bn", "0",
            "--seed", "1"]
    sets = _world(2048) + EARLY_REDUCED + ["DATA_CONFIG.SYNTHETIC",
                                           "{'NUM_SCENES': 3, 'KEYFRAMES_PER_SCENE': 2, "
                                           "'NUM_CARS': 6, 'NUM_PEDS': 0, 'WORLD': 'urban'}"]
    out = train_cli.main(["--cfg_file", EARLY_CFG, *argv, "--epochs", "1", "--set", *sets])
    assert out["steps"] > 0 and np.isfinite(out["losses"]).all()
    assert out["launches"]["bev_scatter_max"] == 0  # the plain version on the CPU
    with pytest.raises(NotImplementedError, match="A11"):
        train_cli.main(["--cfg_file", f"{CFGS}/v2x_second_ego.yaml", *argv, "--epochs", "1",
                        "--set", "MODEL.BACKBONE_3D.NAME", "UNetV2"])
    _, tcfg = cfg_pair("v2x_sim_dataset_ego_early")
    tcfg.DATASET = "KittiDataset"
    tcfg.DATA_SPLIT = {"train": "train", "test": "val"}
    with pytest.raises(FileNotFoundError, match="create_kitti_infos"):
        build_dataloader(tcfg, ["car"], batch_size=1, training=False, workers=0)
