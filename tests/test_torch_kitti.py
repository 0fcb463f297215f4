"""The port's KITTI and custom data path against the JAX package's.

* the calibration's maps and the box conversions of ``utils/box_utils.py``
  on seeded boxes: equal within 1e-6;
* ``create_kitti_infos`` on the fake tree of ``tests/torch_fake_kitti.py``
  (a real PNG of 370 x 1224 read by PIL in the JAX package and from its
  header by the port; the last frame has none): the infos (names, boxes,
  difficulty, ``num_points_in_gt``), the gt database's files and dbinfos,
  and the integrated database, equal exactly;
* ``KittiDataset`` items of ``kitti_models/pointrcnn.yaml`` in training
  (``gt_sampling`` from the per-object files or the integrated database,
  the world flip, rotation and scaling, ``sample_points`` below and above
  the cloud's size) and test mode: numpy's global generator seeded on the
  JAX side, a ``RandomState`` of the same seed on the port's, a sequence of
  items (the sampler's pointer and permutation persist across items):
  points and boxes equal exactly;
* the prediction annotations and the KITTI AP tables of the same
  detections: within 1e-4;
* the custom dataset: infos, items and its KITTI-metric eval; and
  ``custom_models/second.yaml`` and ``pv_rcnn.yaml``, whose shipped z range
  of [-3, 1] m at 0.2 m leaves the sparse backbone's output with no z
  slice: their forward fails in both packages at ``HeightCompression``.
"""
import copy
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.datasets.augmentor.gt_database import create_integrated_database as jax_integrate
from pcp_tpu.datasets.custom.custom_dataset import CustomDataset as JaxCustom
from pcp_tpu.datasets.custom.custom_dataset import create_custom_infos as jax_create_custom
from pcp_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
from pcp_tpu.datasets.kitti.kitti_dataset import create_kitti_infos as jax_create_kitti
from pcp_tpu.datasets.processor.data_processor import DataProcessor as JaxProcessor
from pcp_tpu.utils import box_utils as jax_box
from pcp_tpu.utils.calibration_kitti import Calibration as JaxCalibration
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.datasets.augmentor.gt_database import create_integrated_database
from pcp_tpu_torch.datasets.custom.custom_dataset import CustomDataset, create_custom_infos
from pcp_tpu_torch.datasets.kitti import kitti_dataset
from pcp_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
from pcp_tpu_torch.datasets.processor.data_processor import DataProcessor
from pcp_tpu_torch.tools import create_integrated_database as integrate_cli
from pcp_tpu_torch.utils import box_utils
from pcp_tpu_torch.utils.calibration_kitti import Calibration
from test_torch_datasets import assert_same
from torch_fake_kitti import make_custom_tree, make_kitti_tree

CLASSES = ["Car", "Pedestrian", "Cyclist"]
PRCNN = "tools/cfgs/kitti_models/pointrcnn.yaml"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def cfg_pair(path, **over):
    """The config at ``path`` for the JAX package and for the port, with
    ``over`` applied to DATA_CONFIG."""
    out = []
    for make, load in ((JaxCfg, jax_cfg_from_yaml), (CfgDict, cfg_from_yaml_file)):
        cfg = make()
        load(path, cfg)
        cfg.DATA_CONFIG.update(copy.deepcopy(over))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One fake KITTI tree copied for each package; each package's infos and
    gt database built in its own copy (the port's through its CLI)."""
    base = make_kitti_tree(tmp_path_factory.mktemp("kitti") / "raw")
    jroot, troot = base.parent / "jax", base.parent / "port"
    shutil.copytree(base, jroot)
    shutil.copytree(base, troot)
    jcfg = jax_cfg_from_yaml("tools/cfgs/dataset_configs/kitti_dataset.yaml", JaxCfg())
    jax_create_kitti(jcfg, CLASSES, jroot, jroot)
    kitti_dataset.main(["create_kitti_infos", "tools/cfgs/dataset_configs/kitti_dataset.yaml",
                        "--data_path", str(troot)])
    return jroot, troot


def _calib(tree, cls):
    return cls(str(tree / "training" / "calib" / "000000.txt"))


def _lidar_boxes(rng, n=12):
    return np.concatenate([rng.uniform([5, -15, -2], [40, 15, 0], (n, 3)),
                           rng.uniform([0.5, 0.5, 1.0], [4.5, 2.0, 2.0], (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)


def test_calibration_and_box_conversions_match_jax(trees):
    jroot, _ = trees
    jc, tc = _calib(jroot, JaxCalibration), _calib(jroot, Calibration)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-20, 40, (64, 3)).astype(np.float32)
    for name in ("lidar_to_rect", "rect_to_lidar"):
        np.testing.assert_allclose(getattr(tc, name)(pts), getattr(jc, name)(pts), atol=1e-6,
                                   rtol=0, err_msg=name)
    for a, b in zip(tc.lidar_to_img(pts), jc.lidar_to_img(pts)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    u, v, d = pts[:, 0] * 10, pts[:, 1] * 10, np.abs(pts[:, 2]) + 1
    np.testing.assert_allclose(jc.img_to_rect(u, v, d), tc.img_to_rect(u, v, d), atol=1e-6)
    boxes = _lidar_boxes(rng)
    cam_j = jax_box.boxes3d_lidar_to_kitti_camera(boxes, jc)
    cam_t = box_utils.boxes3d_lidar_to_kitti_camera(boxes, tc)
    np.testing.assert_allclose(cam_t, cam_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(box_utils.boxes3d_kitti_camera_to_lidar(cam_t, tc),
                               jax_box.boxes3d_kitti_camera_to_lidar(cam_j, jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(box_utils.boxes3d_kitti_fakelidar_to_lidar(boxes),
                               jax_box.boxes3d_kitti_fakelidar_to_lidar(boxes), atol=1e-6, rtol=0)
    for bottom in (True, False):
        np.testing.assert_allclose(box_utils.boxes3d_to_corners3d_kitti_camera(cam_t, bottom),
                                   jax_box.boxes3d_to_corners3d_kitti_camera(cam_j, bottom),
                                   atol=1e-6, rtol=0)
    for shape in (None, (370, 1224)):
        np.testing.assert_allclose(
            box_utils.boxes3d_kitti_camera_to_imageboxes(cam_t, tc, shape),
            jax_box.boxes3d_kitti_camera_to_imageboxes(cam_j, jc, shape), atol=1e-6, rtol=0)
    cloud = rng.uniform([0, -20, -3, 0], [45, 20, 1, 1], (4000, 4)).astype(np.float32)
    kept = box_utils.remove_points_in_boxes(cloud, boxes)
    assert 0 < len(kept) < len(cloud)
    np.testing.assert_array_equal(kept, jax_box.remove_points_in_boxes(cloud, boxes))
    ang = rng.uniform(-10, 10, 50)
    np.testing.assert_allclose(box_utils.limit_period(ang), jax_box.limit_period(ang), atol=1e-12)


def test_png_header_shape_and_fallback(trees):
    _, troot = trees
    assert kitti_dataset.png_shape(troot / "training" / "image_2" / "000000.png").tolist() == [370, 1224]
    assert kitti_dataset.png_shape(troot / "training" / "image_2" / "000004.png") is None
    assert kitti_dataset.png_shape(troot / "training" / "calib" / "000000.txt") is None


@pytest.mark.parametrize("split", ["train", "val"])
def test_infos_match_jax(trees, split):
    jroot, troot = trees
    with open(jroot / f"kitti_infos_{split}.pkl", "rb") as f:
        want = pickle.load(f)
    with open(troot / f"kitti_infos_{split}.pkl", "rb") as f:
        got = pickle.load(f)
    assert_same(got, want, split)
    shapes = [info["image"]["image_shape"].tolist() for info in got]
    assert shapes[0] == [370, 1224] and (split == "train" or shapes[-1] == [375, 1242])
    counts = np.concatenate([info["annos"]["num_points_in_gt"] for info in got])
    assert (counts > 0).sum() >= 10 and (counts == -1).sum() == len(got)  # the DontCare rows


def test_gt_database_matches_jax(trees):
    jroot, troot = trees
    with open(jroot / "kitti_dbinfos_train.pkl", "rb") as f:
        want = pickle.load(f)
    with open(troot / "kitti_dbinfos_train.pkl", "rb") as f:
        got = pickle.load(f)
    assert_same(got, want, "dbinfos")
    assert set(got) == set(CLASSES)
    files = sorted(p.name for p in (jroot / "gt_database").iterdir())
    assert files == sorted(p.name for p in (troot / "gt_database").iterdir()) and len(files) > 15
    for name in files:
        assert (troot / "gt_database" / name).read_bytes() == (jroot / "gt_database" / name).read_bytes()


def test_integrated_database_matches_jax(trees, tmp_path):
    jroot, troot = trees
    for root in (jroot, troot):
        shutil.copy(root / "kitti_dbinfos_train.pkl", tmp_path / f"{root.name}.pkl")
    want_infos, want = jax_integrate(tmp_path / "jax.pkl", jroot, "global_jax")
    got_infos, got = integrate_cli.main(["--src_db_info", str(tmp_path / "port.pkl"),
                                         "--root_path", str(troot), "--new_db_name", "global"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(troot / "global.npy"), want)
    assert_same(got_infos, want_infos, "integrated")
    with open(tmp_path / "port.pkl", "rb") as f:
        assert_same(pickle.load(f), want_infos, "integrated pkl")


def _datasets(trees, training, seed, **over):
    jroot, troot = trees
    jcfg, tcfg = cfg_pair(PRCNN, **over)
    jds = JaxKitti(jcfg.DATA_CONFIG, CLASSES, training=training, root_path=jroot)
    tds = KittiDataset(tcfg.DATA_CONFIG, CLASSES, training=training, root_path=troot)
    return jds, tds


def _processor(num_points):
    return [{"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "sample_points", "NUM_POINTS": {"train": num_points, "test": num_points}},
            {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}}]


def _items(jds, tds, order, seed):
    np.random.seed(seed)
    want = [jds[i] for i in order]
    rng = np.random.RandomState(seed)
    got = [tds.get_item(i, rng) for i in order]
    return got, want


def _drop_host(item):
    """The item without the host objects of the metadata (the calibration)."""
    return {k: v for k, v in item.items() if k != "metadata"}


@pytest.mark.parametrize("num_points,integrated", [(1024, False), (4096, False), (1024, True)])
def test_training_items_match_jax(trees, num_points, integrated):
    """gt_sampling then the world flip, rotation and scaling, the range mask,
    sample_points (1024 < the cloud, 4096 > it) and the shuffle."""
    over = {"DATA_PROCESSOR": _processor(num_points)}
    if integrated:
        for root, name in zip(trees, ("jax", "port")):
            shutil.copy(root / "kitti_dbinfos_train.pkl", root / "kitti_dbinfos_train_global.pkl")
        jax_integrate(trees[0] / "kitti_dbinfos_train_global.pkl", trees[0], "gt_global")
        create_integrated_database(trees[1] / "kitti_dbinfos_train_global.pkl", trees[1], "gt_global")
        aug = cfg_pair(PRCNN)[0].DATA_CONFIG.DATA_AUGMENTOR
        aug = copy.deepcopy(dict(aug))
        aug["AUG_CONFIG_LIST"] = [dict(a) for a in aug["AUG_CONFIG_LIST"]]
        aug["AUG_CONFIG_LIST"][0].update({"DB_INFO_PATH": ["kitti_dbinfos_train_global.pkl"],
                                          "DB_DATA_PATH": ["gt_global.npy"]})
        over["DATA_AUGMENTOR"] = aug
    jds, tds = _datasets(trees, True, 11, **over)
    got, want = _items(jds, tds, [0, 1, 2, 0, 2, 1], seed=11)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(_drop_host(g), _drop_host(w), f"item{i}")
        assert g["points"].shape[0] == num_points
        assert (g["gt_boxes"][:, 7] > 0).all() and len(g["gt_boxes"]) > 8  # pasted objects


def test_test_items_match_jax(trees):
    jds, tds = _datasets(trees, False, 0)
    got, want = _items(jds, tds, [0, 1], seed=5)
    for g, w in zip(got, want):
        assert_same(_drop_host(g), _drop_host(w))
        assert g["metadata"]["frame_id"] == w["metadata"]["frame_id"]
        assert g["points"].shape[0] == 16384


@pytest.mark.parametrize("num_points", [-1, 300, 5000])
def test_sample_points_matches_jax(num_points):
    cfg = _processor(num_points)[1:2]
    rng = np.random.default_rng(num_points + 10)
    pts = rng.uniform(-60, 60, (2000, 4)).astype(np.float32)
    np.random.seed(4)
    want = JaxProcessor(cfg, [-70, -40, -3, 70, 40, 1], True, 4).forward({"points": pts.copy()})
    got = DataProcessor(cfg, [-70, -40, -3, 70, 40, 1], True, 4).forward(
        {"points": pts.copy()}, np.random.RandomState(4))
    np.testing.assert_array_equal(got["points"], want["points"])


def _detections(infos, rng):
    """Fixed-shape outputs (numpy) of noisy gt boxes and a few false ones."""
    b, k = len(infos), 12
    out = {"pred_boxes": np.zeros((b, k, 7), np.float32), "pred_scores": np.zeros((b, k), np.float32),
           "pred_labels": np.zeros((b, k), np.int32), "pred_valid": np.zeros((b, k), bool)}
    for i, info in enumerate(infos):
        a = info["annos"]
        keep = a["name"] != "DontCare"
        boxes = a["gt_boxes_lidar"][: keep.sum()]
        n = min(len(boxes), k - 2)
        out["pred_boxes"][i, :n] = boxes[:n] + rng.normal(0, 0.03, (n, 7)) * [1, 1, 0.3, 0.2, 0.1, 0.1, 0.2]
        out["pred_boxes"][i, n:n + 2] = boxes[:2] + [3, 3, 0, 0, 0, 0, 0]
        out["pred_labels"][i, :n] = [CLASSES.index(x) + 1 for x in a["name"][:n]]
        out["pred_labels"][i, n:n + 2] = 1
        out["pred_scores"][i, :n + 2] = rng.uniform(0.2, 1.0, n + 2)
        out["pred_valid"][i, :n + 2] = True
    return out


def test_kitti_eval_matches_jax(trees):
    jds, tds = _datasets(trees, False, 0)
    fbd = _detections(tds.kitti_infos, np.random.default_rng(9))
    batches = []
    for ds, calib in ((jds, JaxCalibration), (tds, Calibration)):
        meta = [{"calib": calib(info["calib"]), "image_shape": info["image"]["image_shape"],
                 "frame_id": info["point_cloud"]["lidar_idx"]} for info in ds.kitti_infos]
        batches.append({"batch_size": len(meta), "metadata": meta})
    want = jds.generate_prediction_dicts(batches[0], fbd, CLASSES)
    got = tds.generate_prediction_dicts(batches[1], fbd, CLASSES)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key in ("name", "frame_id"):
                assert list(np.atleast_1d(g[key])) == list(np.atleast_1d(w[key]))
            else:
                np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=0, err_msg=key)
    want_str, want_ap = jds.evaluation(want, CLASSES)
    got_str, got_ap = tds.evaluation(got, CLASSES)
    assert set(got_ap) == set(want_ap) and len(got_ap) == 36
    for key, v in want_ap.items():
        assert got_ap[key] == pytest.approx(v, abs=1e-4), key
    assert max(got_ap.values()) > 5  # the noisy gt is found (few gt: R40 reaches 12.5 at most)
    assert got_str.splitlines()[0] == want_str.splitlines()[0] == "Car AP@0.70, 0.70, 0.70:"


@pytest.fixture(scope="module")
def custom_trees(tmp_path_factory):
    base = make_custom_tree(tmp_path_factory.mktemp("custom") / "raw")
    jroot, troot = base.parent / "jax", base.parent / "port"
    shutil.copytree(base, jroot)
    shutil.copytree(base, troot)
    jcfg, tcfg = cfg_pair("tools/cfgs/custom_models/second.yaml")
    jax_create_custom(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, jroot, jroot)
    create_custom_infos(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, troot, troot)
    return jroot, troot, jcfg, tcfg


def test_custom_infos_items_and_eval_match_jax(custom_trees):
    jroot, troot, jcfg, tcfg = custom_trees
    for name in ("custom_infos_train.pkl", "custom_infos_val.pkl", "custom_dbinfos_train.pkl"):
        with open(jroot / name, "rb") as f, open(troot / name, "rb") as g:
            assert_same(pickle.load(g), pickle.load(f), name)
    for training, order in ((True, [0, 1, 0]), (False, [0])):
        jds = JaxCustom(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=training, root_path=jroot)
        tds = CustomDataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=training, root_path=troot)
        got, want = _items(jds, tds, order, seed=3)
        for g, w in zip(got, want):
            assert_same(g, w)
    fbd = _detections([{"annos": {"name": np.array([{"Vehicle": "Car"}.get(n, n) for n in i["annos"]["name"]]),
                                  "gt_boxes_lidar": i["annos"]["gt_boxes_lidar"]}} for i in tds.custom_infos],
                      np.random.default_rng(2))
    batch = {"batch_size": len(tds.custom_infos),
             "metadata": [{"frame_id": i["point_cloud"]["lidar_idx"]} for i in tds.custom_infos]}
    want_annos = jds.generate_prediction_dicts(batch, fbd, jcfg.CLASS_NAMES)
    got_annos = tds.generate_prediction_dicts(batch, fbd, tcfg.CLASS_NAMES)
    _, want_ap = jds.evaluation(want_annos, jcfg.CLASS_NAMES)
    _, got_ap = tds.evaluation(got_annos, tcfg.CLASS_NAMES)
    assert set(got_ap) == set(want_ap) and got_ap
    for key, v in want_ap.items():
        assert got_ap[key] == pytest.approx(v, abs=1e-4), key


@pytest.mark.parametrize("model", ["second", "pv_rcnn"])
def test_custom_second_fails_at_the_z_extent_in_both(model):
    """The shipped custom SECOND and PV-RCNN (the same sparse backbone): 20
    z slices of 0.2 m ([-3, 1]) give sparse dims (21, 800, 1408) and,
    through the backbone's strides, a conv_out with no z slice;
    HeightCompression then gives 0 channels where NUM_BEV_FEATURES is 256.
    The xy range is cut to 12.8 m (z as shipped)."""
    from pcp_tpu.models import build_network as build_jax
    from pcp_tpu.models.detectors.detector_template import DatasetInfo as JaxInfo
    from pcp_tpu_torch.models import DatasetInfo, build_network

    jcfg, tcfg = cfg_pair(f"tools/cfgs/custom_models/{model}.yaml",
                          POINT_CLOUD_RANGE=[0.0, -6.4, -3.0, 12.8, 6.4, 1.0])
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform([0.5, -6, -2.5], [12, 6, 0.5], (1, 64, 3)),
                          rng.uniform(0, 1, (1, 64, 1))], -1).astype(np.float32)
    jinfo = JaxInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    assert jinfo.grid_size == (128, 128, 20)
    jm = build_jax(jcfg.MODEL, num_class=3, dataset_info=jinfo)
    batch = {"points": jnp.asarray(pts), "points_mask": jnp.ones((1, 64), bool), "batch_size": 1}
    with pytest.raises(AssertionError, match="256"):  # raised while tracing: shapes only
        jax.eval_shape(lambda p, m: jm.init(jax.random.PRNGKey(0), dict(
            batch, points=p, points_mask=m), train=False), batch["points"], batch["points_mask"])
    tm = build_network(tcfg.MODEL, num_class=3,
                       dataset_info=DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES),
                       device="cpu")
    with pytest.raises(ValueError, match="gives 0 channels, NUM_BEV_FEATURES is 256"):
        with torch.no_grad():
            tm({"points": torch.from_numpy(pts), "points_mask": torch.ones((1, 64), dtype=torch.bool)})


# PointRCNN at a tiny size through --set: the structure of pointrcnn.yaml
# (four SA levels of two scales, the point head, the ROI head), narrow
# widths, 1024 points, few proposals
TINY_PRCNN = [
    "DATA_CONFIG.DATA_PROCESSOR", repr(_processor(1024)),
    "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "1024",
    "MODEL.BACKBONE_3D.SA_CONFIG.NPOINTS", "[256, 64, 16, 8]",
    "MODEL.BACKBONE_3D.SA_CONFIG.NSAMPLE", "[[8, 8], [8, 8], [8, 8], [8, 8]]",
    "MODEL.BACKBONE_3D.SA_CONFIG.MLPS", "[[[8], [8]], [[16], [16]], [[16], [16]], [[16], [16]]]",
    "MODEL.BACKBONE_3D.FP_MLPS", "[[16], [16], [16], [16]]",
    "MODEL.POINT_HEAD.CLS_FC", "[16]", "MODEL.POINT_HEAD.REG_FC", "[16]",
    "MODEL.ROI_HEAD.ROI_POINT_POOL.NUM_SAMPLED_POINTS", "32",
    "MODEL.ROI_HEAD.XYZ_UP_LAYER", "[16, 16]", "MODEL.ROI_HEAD.CLS_FC", "[16]",
    "MODEL.ROI_HEAD.REG_FC", "[16]",
    "MODEL.ROI_HEAD.SA_CONFIG.NPOINTS", "[16, 8, -1]",
    "MODEL.ROI_HEAD.SA_CONFIG.NSAMPLE", "[8, 8, 8]",
    "MODEL.ROI_HEAD.SA_CONFIG.MLPS", "[[16], [16], [16]]",
    "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE", "512",
    "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE", "64",
    "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE", "512",
    "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE", "32",
    "MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE", "16",
]


def test_pointrcnn_trains_and_evaluates_through_the_clis(trees, tmp_path):
    """One epoch of the tiny PointRCNN with gt_sampling on the port's KITTI
    tree through the train CLI, then the test CLI's KITTI AP table."""
    from pcp_tpu_torch.tools import test as test_cli
    from pcp_tpu_torch.tools import train as train_cli

    _, troot = trees
    sets = ["DATA_CONFIG.DATA_PATH", str(troot)] + TINY_PRCNN
    common = ["--cfg_file", PRCNN, "--batch_size", "2", "--workers", "0", "--device", "cpu",
              "--extra_tag", "tiny", "--output_root", str(tmp_path)]
    out = train_cli.main(common + ["--epochs", "1", "--seed", "3", "--num_epochs_to_eval", "0",
                                   "--precise_bn", "2", "--set", *sets])
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    assert set(out["launches"].values()) == {0}  # PointRCNN reaches no CUDA kernel
    run_dir = tmp_path / "cfgs" / "kitti_models" / "pointrcnn" / "tiny"
    ckpt = run_dir / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(common + ["--ckpt", str(ckpt), "--set", *sets])
    assert "Car_3d/moderate_R40" in result and "recall/rcnn_0.7" in result
    logs = list((run_dir / "eval").glob("log_eval_*.txt"))
    assert "Car AP@0.70, 0.70, 0.70:" in logs[0].read_text()
