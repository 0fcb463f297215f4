"""The port's nuScenes data path against the JAX package's.

* ``create_nuscenes_infos`` on the fake database of
  ``tests/torch_fake_devkit.py`` (two scenes, the first train, of two
  keyframes after two non-key sweeps each, ten classes of moving objects):
  both packages' pickles equal, arrays exactly (NaN where a velocity has no
  neighbour, in both);
* ``NuScenesDataset`` items and batches of ``pointpillar_jr_nomap`` and of
  ``pointpillar_jr_withmap`` (its map read from a ``.npz`` raster named by
  each info's ``map_path``), in training (the world flip, rotation, scaling
  and translation; ``gt_sampling`` disabled) and test mode, seeded alike:
  equal exactly;
* the balanced resampling: numpy's global generator seeded on the JAX side,
  a ``RandomState`` of the same seed on the port's, the same infos drawn;
* ``evaluation`` of the same detections: every metric within 1e-9 (NaN
  in both for a class without gt);
* ``map_utils`` with OpenCV hidden from the JAX package (its fallback route,
  which is the port's only one): rasters equal exactly;
* ``temporal_utils``: ``tests/test_instance_centric.py``'s cases on the
  port, and each output equal to the JAX package's (transforms and boxes
  within 1e-12, instance tags exactly).
"""
import copy
import pickle
import sys

import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import ROOT_DIR
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.datasets.nuscenes import map_utils as jax_map
from pcp_tpu.datasets.nuscenes import temporal_utils as jax_temporal
from pcp_tpu.datasets.nuscenes.info_builder import create_nuscenes_infos as jax_create
from pcp_tpu.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as JaxNuScenes
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.datasets.nuscenes import map_utils, temporal_utils
from pcp_tpu_torch.datasets.nuscenes.info_builder import create_nuscenes_infos
from pcp_tpu_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from test_torch_datasets import assert_same
from torch_fake_devkit import make_nusc_db, write_maps

CLASSES = ['car', 'truck', 'construction_vehicle', 'bus', 'trailer', 'barrier', 'motorcycle',
           'bicycle', 'pedestrian', 'traffic_cone']


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _assert_infos_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray) and x[k].dtype.kind == "f":
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)  # NaN == NaN here
            elif k == "sweeps":
                assert len(x[k]) == len(y[k])
                for s, t in zip(x[k], y[k]):
                    assert set(s) == set(t)
                    for kk in s:
                        if s[kk] is None or isinstance(s[kk], (str, float)):
                            assert s[kk] == t[kk], kk
                        else:
                            np.testing.assert_array_equal(s[kk], t[kk], err_msg=kk)
            else:
                assert_same(x[k], y[k], k)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The fake database, both packages' infos built from it (into their own
    directories), the port's ``.npz`` maps on each info."""
    root = tmp_path_factory.mktemp("nusc")
    fake, version = make_nusc_db(root, num_scenes=2, keyframes=2, sweeps=3, points=600,
                                 objects=12, seed=4)
    data = root / version
    jinfos = jax_create(version, data, root / "jax", max_sweeps=3, nusc=fake)
    tinfos = create_nuscenes_infos(version, data, data, max_sweeps=3, nusc=fake)
    for split, infos in zip(("train", "val"), copy.deepcopy(tinfos)):
        write_maps(data, infos, map_utils.make_map_representation,
                   (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), seed=len(split))
        with open(data / f"nuscenes_infos_3sweeps_{split}.pkl", "wb") as f:
            pickle.dump(infos, f)
    return {"fake": fake, "root": root, "version": version, "jax": jinfos, "torch": tinfos}


def test_infos_equal_jax(db):
    for split in (0, 1):
        _assert_infos_equal(db["jax"][split], db["torch"][split])
    train, val = db["torch"]
    assert len(train) == len(val) == 2
    info = train[1]
    assert len(info["sweeps"]) == 2 and info["sweeps"][0]["time_lag"] > 0
    assert info["gt_boxes"].shape[1] == 9 and set(info["gt_names"]) <= set(CLASSES)
    assert np.isfinite(info["gt_boxes"][:, 7:9]).all()  # keyframe 1 has a neighbour
    # the pickles on disk are what create_nuscenes_infos returned (maps added after)
    with open(db["root"] / "jax" / "nuscenes_infos_3sweeps_val.pkl", "rb") as f:
        _assert_infos_equal(pickle.load(f), db["jax"][1])


def _dataset_cfgs(db, name, **over):
    out = []
    for make, load in ((JaxCfg, jax_cfg_from_yaml), (CfgDict, cfg_from_yaml_file)):
        cfg = load(str(ROOT_DIR / f"tools/cfgs/nuscenes_models/{name}.yaml"), make())
        d = cfg.DATA_CONFIG
        d.update({"DATA_PATH": str(db["root"]), "VERSION": db["version"], "MAX_SWEEPS": 3,
                  "INFO_PATH": {"train": ["nuscenes_infos_3sweeps_train.pkl"],
                                "test": ["nuscenes_infos_3sweeps_val.pkl"]},
                  "MAX_POINTS_PER_SAMPLE": 4096})
        d.DATA_AUGMENTOR.DISABLE_AUG_LIST = ["gt_sampling"]
        d.update(copy.deepcopy(over))
        out.append((d, list(cfg.CLASS_NAMES)))
    return out


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", ["pointpillar_jr_nomap", "pointpillar_jr_withmap"])
def test_items_equal_jax(db, name, training):
    (jcfg, classes), (tcfg, _) = _dataset_cfgs(db, name)
    jds = JaxNuScenes(jcfg, classes, training=training)
    tds = NuScenesDataset(tcfg, classes, training=training)
    assert len(jds) == len(tds) == 2
    np.random.seed(11)
    tds.rng = np.random.RandomState(11)
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    for a, b in zip(jitems, titems):
        assert_same(a, b)
        # x, y, z, intensity, lag (+ 5 map features): no sweep or instance column
        assert b["points"].shape[1] == (10 if "withmap" in name else 5)
    assert_same(jds.collate_batch(jitems), tds.collate_batch(titems))


def test_balanced_resampling_draws_as_jax(db):
    (jcfg, classes), (tcfg, _) = _dataset_cfgs(db, "pointpillar_jr_nomap",
                                               BALANCED_RESAMPLING=True)
    jcfg.INFO_PATH = tcfg.INFO_PATH = {"train": ["nuscenes_infos_3sweeps_train.pkl",
                                                 "nuscenes_infos_3sweeps_val.pkl"], "test": []}
    for seed in (0, 3):
        np.random.seed(seed)
        jds = JaxNuScenes(jcfg, classes, training=True)
        tds = NuScenesDataset(tcfg, classes, training=True)
        got = tds.balanced_infos_resampling(_plain(tds), np.random.RandomState(seed))
        assert [i["token"] for i in got] == [i["token"] for i in jds.infos]
        assert len(got) > 4  # classes met once are drawn again


def _plain(ds):
    """The dataset's infos before resampling, read again."""
    infos = []
    for p in ds.dataset_cfg.INFO_PATH["train"]:
        with open(ds.root_path / p, "rb") as f:
            infos.extend(pickle.load(f))
    return infos


def test_evaluation_equals_jax(db):
    (jcfg, classes), (tcfg, _) = _dataset_cfgs(db, "pointpillar_jr_nomap")
    jds = JaxNuScenes(jcfg, classes, training=False)
    tds = NuScenesDataset(tcfg, classes, training=False)
    rng = np.random.default_rng(2)
    annos = []
    for info in tds.infos:  # the gt, moved a little, and a few false boxes
        gt = info["gt_boxes"][:, :7] + rng.normal(0, 0.3, (len(info["gt_boxes"]), 7))
        boxes = np.concatenate([gt, rng.uniform(-20, 20, (3, 7))]).astype(np.float32)
        names = np.concatenate([info["gt_names"], rng.choice(CLASSES, 3)])
        annos.append({"boxes_lidar": boxes, "score": rng.uniform(0.1, 1, len(boxes)),
                      "name": names, "pred_labels": np.array([CLASSES.index(n) + 1 for n in names]),
                      "metadata": {"lidar_token": info["token"]}})
    _, jres = jds.evaluation(copy.deepcopy(annos), classes)
    _, tres = tds.evaluation(copy.deepcopy(annos), classes)
    assert set(jres) == set(tres) and 0 < tres["mAP"] <= 1
    for k, v in jres.items():  # NaN (a class without gt) in both, or within 1e-9
        assert tres[k] == pytest.approx(v, abs=1e-9, nan_ok=True), k


def test_withmap_without_map_path_needs_the_devkit(db):
    """An info without ``map_path`` takes its map from ``MapMaker``, through
    the devkit, in both packages."""
    (jcfg, classes), (tcfg, _) = _dataset_cfgs(db, "pointpillar_jr_withmap")
    for cls, cfg in ((JaxNuScenes, jcfg), (NuScenesDataset, tcfg)):
        ds = cls(cfg, classes, training=False)
        ds.infos = [{k: v for k, v in i.items() if k != "map_path"} for i in ds.infos]
        with pytest.raises(ImportError):
            ds[0]


# -------------------------------------------------------------- map_utils
MAP_PC = (-12.8, -12.8, -5.0, 12.8, 12.8, 3.0)


def _geometry(rng):
    polys = []
    for _ in range(3):
        c, n = rng.uniform(-10, 10, 2), rng.integers(3, 9)
        ang, rad = np.sort(rng.uniform(0, 2 * np.pi, n)), rng.uniform(1, 6, n)
        polys.append(np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1))
    polys.append(rng.uniform(-12, 12, (6, 2)))  # self-intersecting
    lanes = {f"l{k}": np.concatenate([rng.uniform(-14, 14, (5, 2)),
                                      rng.uniform(-np.pi, np.pi, (5, 1))], 1) for k in range(3)}
    return polys, lanes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_rasters_equal_jax_fallback(monkeypatch, seed):
    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX package's numpy/matplotlib route
    rng = np.random.default_rng(seed)
    polys, lanes = _geometry(rng)
    canvas = (128, 128)
    np.testing.assert_array_equal(map_utils.rasterize_polygons(polys, MAP_PC, 0.2, canvas),
                                  jax_map.rasterize_polygons(polys, MAP_PC, 0.2, canvas))
    for norm in (False, True):
        np.testing.assert_array_equal(
            map_utils.draw_lane_in_bev(lanes, MAP_PC, 0.2, canvas, normalize_lane_angle=norm),
            jax_map.draw_lane_in_bev(lanes, MAP_PC, 0.2, canvas, normalize_lane_angle=norm))
    g2s = np.eye(4)
    g2s[:2, :2] = [[np.cos(0.4), -np.sin(0.4)], [np.sin(0.4), np.cos(0.4)]]
    g2s[:2, 3] = [1.5, -2.0]
    lanes_g = {k: np.concatenate([v[:, :2], np.arctan2(np.sin(v[:, 2:]), np.cos(v[:, 2:]))], 1)
               for k, v in lanes.items()}
    got = map_utils.map_lanes_to_sensor(g2s, lanes_g)
    want = jax_map.map_lanes_to_sensor(g2s, lanes_g)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    layers = {"drivable_area": polys[:2], "walkway": polys[2:]}
    rep = map_utils.make_map_representation(layers, lanes_g, g2s, MAP_PC, 0.2)
    np.testing.assert_array_equal(rep, jax_map.make_map_representation(layers, lanes_g, g2s,
                                                                       MAP_PC, 0.2))
    pts = rng.uniform(-15, 15, (500, 5))
    np.testing.assert_array_equal(map_utils.interpolate_map_at_points(rep, pts, MAP_PC, 0.2),
                                  jax_map.interpolate_map_at_points(rep, pts, MAP_PC, 0.2))
    np.testing.assert_array_equal(map_utils.put_in_2pi(lanes_g["l0"][:, 2]),
                                  jax_map.put_in_2pi(lanes_g["l0"][:, 2]))


def test_map_maker_needs_the_devkit():
    with pytest.raises(ImportError, match="nuscenes-devkit"):
        map_utils.MapMaker(None)


# ---------------------------------------------------------- temporal_utils
def _pose(x, y, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = [x, y, 0.0]
    return m


def _both(*args, **kwargs):
    got = temporal_utils.build_instance_centric_sample(*args, **kwargs)
    want = jax_temporal.build_instance_centric_sample(*args, **kwargs)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["points"], want["points"])
    for k in ("instances_tf", "gt_boxes"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0)
    assert got["gt_names"].tolist() == want["gt_names"].tolist()
    return got


def test_instances_tf_corrects_history():
    n_sweeps = 4
    sweep_points, sweep_boxes = [], []
    for s in range(3):
        x = float(s)
        sweep_points.append(np.array([[x + 0.5, 0.2, 0.0, 0.5, 0.1 * (2 - s), s]]))
        sweep_boxes.append({"carA": np.array([x, 0.0, 0.0, 4.0, 2.0, 1.6, 0.1 * s])})
    out = _both(sweep_points, sweep_boxes, n_sweeps)
    tf = out["instances_tf"]
    assert tf.shape == (1, n_sweeps, 4, 4)
    last = _pose(2.0, 0.0, 0.2)
    for s in range(3):
        np.testing.assert_allclose(tf[0, s] @ _pose(float(s), 0.0, 0.1 * s), last, atol=1e-9)
    np.testing.assert_allclose(tf[0, 3], 0.0)
    np.testing.assert_allclose(out["gt_boxes"][0, :3], [2.0, 0.0, 0.0], atol=1e-9)
    np.testing.assert_allclose(out["gt_boxes"][0, 6], 0.2, atol=1e-9)
    assert (out["points"][:, -1] == 0).all()


def test_background_points_tagged_minus_one():
    out = _both([np.array([[50.0, 50.0, 0.0, 1.0, 0.0, 0]])],
                [{"a": np.array([0.0, 0, 0, 4, 2, 1.6, 0.0])}], 2)
    assert out["points"][0, -1] == -1


def test_two_instances_distinct_ids():
    boxes0 = {"a": np.array([0.0, 0, 0, 4, 2, 1.6, 0.0]),
              "b": np.array([10.0, 0, 0, 4, 2, 1.6, 0.0])}
    out = _both([np.array([[0.1, 0, 0, 1, 0, 0], [10.1, 0, 0, 1, 0, 0]])], [boxes0], 2)
    assert out["instances_tf"].shape[0] == 2
    assert set(out["points"][:, -1].astype(int)) == {0, 1}


def test_no_instances_empty_outputs():
    out = _both([np.zeros((3, 6))], [{}], 5)
    assert out["instances_tf"].shape == (0, 5, 4, 4)
    assert out["gt_boxes"].shape == (0, 9)
    assert (out["points"][:, -1] == -1).all()


def test_random_instances_equal_jax():
    rng = np.random.default_rng(9)
    sweep_points, sweep_boxes = [], []
    keys = [f"k{i}" for i in range(6)]
    for s in range(4):
        pts = np.concatenate([rng.uniform(-15, 15, (300, 3)), rng.uniform(0, 1, (300, 2)),
                              np.full((300, 1), s)], 1)
        sweep_points.append(pts)
        sweep_boxes.append({k: np.array([*rng.uniform(-12, 12, 2), 0.0, 4.0, 2.0, 1.6,
                                         rng.uniform(-np.pi, np.pi)])
                            for k in keys if rng.uniform() < 0.8})
    out = _both(sweep_points, sweep_boxes, 5,
                instance_names={k: "pedestrian" for k in keys[:2]},
                instance_velocities={k: rng.normal(size=3) for k in keys[2:]})
    assert (out["points"][:, -1] >= 0).any()


def test_remove_ego_points():
    pts = np.array([[0.5, 0.5, 0.0], [3.0, 0.0, 0.0], [-1.0, 1.9, 0.0]])
    np.testing.assert_array_equal(temporal_utils.remove_ego_vehicle_points(pts),
                                  jax_temporal.remove_ego_vehicle_points(pts))
    with pytest.raises(ImportError, match="nuscenes-devkit"):
        temporal_utils.revised_instance_centric_get_sweeps(None, "s", 3)
