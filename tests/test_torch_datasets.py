"""The port's data pipeline against the JAX package's on a tiny synthetic world.

* the world: every frame of one config equal in both packages;
* the native host kernels equal their plain numpy versions, and a failed
  build raises;
* points in boxes: the port's exchange route, its source's route, the JAX
  package's and the plain version agree on points within 1e-5 of a face;
* items: RSU, car and ego ``dataset[i]`` in training and test mode, seeded
  alike (``np.random.seed`` on the JAX side, a ``RandomState`` on the port's),
  equal key for key, arrays exactly, and so is ``collate_batch``;
* the ego's exchange levers on a database both read (boxflow, the legacy
  modar + foreground pooling, EXCHANGE_NOW, no flow propagation,
  EXCHANGE_ORACLE, EXCHANGE_ORACLE_FLOW, EXCHANGE_DROPOUT 0.5 at evaluation,
  where it repeats, and in training, and the single-agent ego's
  EXCHANGE_MODAR False, which appends no MoDAR row);
* the loader: the same seed gives the same batches with 0 and 2 workers;
* the exchange generator writes files for both splits;
* what is not ported raises, naming its ROADMAP item; the real V2X-Sim
  source without the devkit raises ImportError, as the JAX package's.
"""
import copy

import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.datasets import build_dataloader as jax_build_dataloader
from pcp_tpu.datasets.v2x_sim.source import SyntheticV2XSource as JaxSource
from pcp_tpu.datasets.v2x_sim.source import _points_in_boxes_np as jax_points_in_boxes
from pcp_tpu.exchange import ExchangeDatabase as JaxExchangeDatabase
from pcp_tpu.exchange.database import pool_box_flow
from pcp_tpu_torch import native
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.datasets import build_dataloader
from pcp_tpu_torch.datasets.loader import DataLoader
from pcp_tpu_torch.datasets.v2x_sim.source import SyntheticV2XSource, _points_in_boxes_np
from pcp_tpu_torch.exchange.database import points_in_boxes_np as exchange_points_in_boxes
from pcp_tpu_torch.ops.points_in_boxes import points_in_boxes as torch_points_in_boxes

SYN = {"NUM_SCENES": 3, "KEYFRAMES_PER_SCENE": 3, "NUM_CARS": 8, "NUM_PEDS": 2, "WORLD": "urban",
       "NUM_PARKED": 4, "VISIBLE_FACES": True}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the test suite runs several processes at once,
    and more threads than cores slow every one of them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def cfg_pair(name, **over):
    """The dataset config ``name`` for the JAX package and for the port, on
    the tiny world, with ``over`` applied."""
    out = []
    for make, load in ((JaxCfg, jax_cfg_from_yaml), (CfgDict, cfg_from_yaml_file)):
        cfg = make()
        load(f"tools/cfgs/dataset_configs/{name}.yaml", cfg)
        cfg.update({"USE_SYNTHETIC_DATA": True, "MAX_POINTS_PER_SAMPLE": 4096,
                    "MINI_TRAINVAL_STRIDE": 1, "SYNTHETIC": dict(SYN)})
        cfg.update(copy.deepcopy(over))
        out.append(cfg)
    return out


def assert_same(a, b, path="item"):
    """Equal key for key; arrays of the same dtype and shape, exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            assert a.tolist() == b.tolist(), path
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) == type(b) and (a == b or str(a) == str(b)), (path, a, b)


def datasets(name, training, seed=7, **over):
    """(JAX dataset, port dataset), both seeded with ``seed``."""
    jcfg, tcfg = cfg_pair(name, **over)
    jds, _, _ = jax_build_dataloader(jcfg, ["car"], batch_size=2, training=training, workers=0)
    tds, _, _ = build_dataloader(tcfg, ["car"], batch_size=2, training=training, workers=0)
    np.random.seed(seed)
    tds.rng = np.random.RandomState(seed)
    return jds, tds


def test_world_equals_jax():
    kwargs = dict(num_scenes=3, keyframes_per_scene=3, num_cars=8, num_peds=2, world="urban",
                  num_parked=4, visible_faces=True)
    jsrc, tsrc = JaxSource(**kwargs), SyntheticV2XSource(**kwargs)
    for scene in tsrc.scenes:
        for kf in range(scene.num_keyframes):
            for lid in range(6):
                token = tsrc.lidar_token(scene, kf, lid)
                assert_same(jsrc.get_frame(token), tsrc.get_frame(token), token)
                np.testing.assert_array_equal(jsrc.get_pose(token), tsrc.get_pose(token))
    assert jsrc.sample_record("scene1_kf1") == tsrc.sample_record("scene1_kf1")


def _native_cases(rng):
    pts = rng.uniform(-30, 30, (3000, 7)).astype(np.float32)
    se3 = np.eye(4)
    se3[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    se3[:3, 3] = rng.normal(0, 5, 3)
    poses = np.stack([np.eye(4)] * 11)
    poses[:, :3, 3] = rng.normal(0, 3, (11, 3))
    boxes = np.concatenate([rng.uniform(-15, 15, (9, 2)), rng.uniform(-1, 1, (9, 1)),
                            rng.uniform(2, 8, (9, 3)), rng.uniform(-3, 3, (9, 1))],
                           axis=1).astype(np.float32)
    return {
        "transform_points_": (pts.copy(), se3),
        "sweep_expand": (pts[:200, :4], poses, 1.0 - np.linspace(0, 1, 11), 3),
        "range_mask_pad": (pts, -12.5, -20.0, 14.0, 9.5, 2048),
        "points_in_boxes_np": (pts[:, :3] * np.float32([0.6, 0.6, 0.1]), boxes),
    }


@pytest.mark.parametrize("name", ["transform_points_", "sweep_expand", "range_mask_pad",
                                  "points_in_boxes_np"])
def test_native_equals_plain(name):
    args = _native_cases(np.random.default_rng(1))[name]
    plain = getattr(native, name.rstrip("_").replace("_np", "") + "_plain")
    got, want = getattr(native, name)(*copy.deepcopy(args)), plain(*copy.deepcopy(args))
    if isinstance(want, tuple):
        assert got[1] == want[1]
        got, want = got[0], want[0]
    if name == "points_in_boxes_np":
        assert (want >= 0).sum() > 50
        np.testing.assert_array_equal(got, want)
    else:  # the native kernels round their double sums once; numpy's float32 matmul differs
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "FLAGS", ["-O3", "--no-such-flag", "-shared", "-fPIC"])
    with pytest.raises(RuntimeError, match="native point-cloud kernels failed"):
        native.points_in_boxes_np(np.zeros((2, 3)), np.ones((1, 7)))


def test_points_in_boxes_routes_agree_near_faces():
    """Points within 1e-5 of each face of turned boxes: the exchange's and the
    source's route (both native), the JAX package's and the plain version
    agree exactly; the torch query of the serving path too."""
    rng = np.random.default_rng(5)
    boxes = np.array([[1.0, -2.0, -1.0, 4.2, 1.8, 1.6, 0.0],
                      [8.0, 3.0, -0.8, 4.6, 2.0, 1.5, 0.7],
                      [-6.0, 5.0, -1.2, 0.7, 0.7, 1.8, -2.3]], dtype=np.float32)
    pts = []
    for b in boxes:
        c, s = np.cos(b[6]), np.sin(b[6])
        for axis, half in ((0, b[3] / 2), (1, b[4] / 2), (2, b[5] / 2)):
            for sign in (-1.0, 1.0):
                local = rng.uniform(-0.45, 0.45, (40, 3)) * b[3:6]
                local[:, axis] = sign * half + rng.uniform(-1e-5, 1e-5, 40)
                pts.append(np.stack([b[0] + local[:, 0] * c - local[:, 1] * s,
                                     b[1] + local[:, 0] * s + local[:, 1] * c,
                                     b[2] + local[:, 2]], axis=1))
    pts = np.concatenate(pts).astype(np.float32)
    want = native.points_in_boxes_plain(pts, boxes)
    assert 0 < (want >= 0).sum() < len(pts)
    np.testing.assert_array_equal(exchange_points_in_boxes(pts, boxes), want)
    np.testing.assert_array_equal(_points_in_boxes_np(pts, boxes), want)
    np.testing.assert_array_equal(jax_points_in_boxes(pts, boxes), want)
    np.testing.assert_array_equal(
        torch_points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes)).numpy(), want)


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", ["v2x_sim_dataset_rsu", "v2x_sim_dataset_car",
                                  "v2x_sim_dataset_ego"])
def test_items_equal_jax(name, training):
    jds, tds = datasets(name, training)
    assert len(jds) == len(tds) > 0
    assert [i["lidar_token"] for i in jds.infos] == [i["lidar_token"] for i in tds.infos]
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    for a, b in zip(jitems, titems):
        assert_same(a, b)
    assert_same(jds.collate_batch(jitems[:3]), tds.collate_batch(titems[:3]))


@pytest.fixture(scope="module")
def exchange_dirs(tmp_path_factory):
    """Two exchange databases written by the JAX package's writer from the
    same seeded MoDAR arrays (each sender's gt, jittered, with a score and
    label 1, and foreground points with flow in the boxes): ``boxflow``
    holds all three kinds, ``legacy`` modar and foreground only."""
    root = tmp_path_factory.mktemp("exchange")
    rng = np.random.default_rng(11)
    src = JaxSource(num_scenes=3, keyframes_per_scene=3, num_cars=8, num_peds=2, world="urban",
                    num_parked=4, visible_faces=True)
    full, legacy = JaxExchangeDatabase(root / "boxflow"), JaxExchangeDatabase(root / "legacy")
    for scene, kf in src.iter_samples():
        token = src.sample_token(scene, kf)
        for lid in (0, 2, 3, 4, 5):
            boxes = src.get_frame(src.lidar_token(scene, kf, lid), classes_of_interest=("car",))["boxes"]
            if boxes.shape[0] == 0:
                continue
            modar = np.zeros((boxes.shape[0], 9), np.float32)
            modar[:, :7] = boxes + rng.normal(0, 0.1, boxes.shape)
            modar[:, 7] = rng.uniform(0.3, 1.0, boxes.shape[0])
            modar[:, 8] = 1.0
            fg = np.zeros((4 * boxes.shape[0], 13), np.float32)
            fg[:, :3] = np.repeat(boxes[:, :3], 4, axis=0) + rng.uniform(-0.3, 0.3, (len(fg), 3))
            fg[:, 7:10] = rng.dirichlet(np.ones(3), len(fg))
            fg[:, 10:13] = rng.normal(0, 0.5, (len(fg), 3))
            for db in (full, legacy):
                db.save_modar(token, lid, modar)
                db.save_foreground(token, lid, fg)
            full.save_boxflow(token, lid, pool_box_flow(modar, fg))
    return root


LEVERS = {
    "boxflow": ("boxflow", False, {}),
    "legacy": ("legacy", False, {}),
    "now": ("boxflow", False, {"EXCHANGE_NOW": True}),
    "noflow": ("legacy", False, {"EXCHANGE_FLOW_PROPAGATION": False}),
    "oracle": ("boxflow", False, {"EXCHANGE_ORACLE": True}),
    "oracle_flow": ("boxflow", False, {"EXCHANGE_ORACLE_FLOW": True}),
    "dropout_eval": ("boxflow", False, {"EXCHANGE_DROPOUT": 0.5}),
    "dropout_train": ("boxflow", True, {"EXCHANGE_DROPOUT": 0.5}),
    "no_modar": ("boxflow", True, {"EXCHANGE_MODAR": False}),  # the single-agent ego
}


@pytest.mark.parametrize("lever", list(LEVERS))
def test_ego_exchange_levers_equal_jax(lever, exchange_dirs):
    directory, training, over = LEVERS[lever]
    jds, tds = datasets("v2x_sim_dataset_ego", training,
                        EXCHANGE_DATABASE_DIRECTORY=str(exchange_dirs / directory),
                        EVAL_FILTER_GT_BEYOND_RANGE=60.0, **over)
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    for a, b in zip(jitems, titems):
        assert_same(a, b)
    n_modar = sum(v[1] for t in titems for v in t["metadata"].get("exchange", {}).values())
    if over.get("EXCHANGE_MODAR", True):
        assert n_modar > 0, "no MoDAR row reached the ego"
    else:
        assert n_modar == 0
    assert tds._exchange_misses == jds._exchange_misses
    if lever == "dropout_eval":  # the lossy broadcast repeats at evaluation
        tds.rng = np.random.RandomState(7)
        assert_same(titems, [tds[i] for i in range(len(tds))])


def test_loader_reproducible_across_workers():
    _, tcfg = cfg_pair("v2x_sim_dataset_rsu")
    ds, _, _ = build_dataloader(tcfg, ["car"], batch_size=2, training=True, workers=0)

    def epoch(workers, e):
        loader = DataLoader(ds, batch_size=2, shuffle=True, seed=3, drop_last=True,
                            num_workers=workers)
        loader.set_epoch(e)
        return [{k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in b.items()}
                for b in loader]

    first = epoch(0, 1)
    assert len(first) == len(ds) // 2
    assert_same(first, epoch(2, 1))
    assert not np.array_equal(first[0]["points"], epoch(0, 2)[0]["points"])


def test_generator_covers_both_splits(tmp_path):
    """The generator writes files for the train split (towns 4 and 5) and
    the val split (town 3), every sample once."""
    from pcp_tpu_torch.entry import CFG_CAR, build
    from pcp_tpu_torch.train.train_state import init_weights
    from pcp_tpu_torch.workspace.v2x_gen_exchange_database import gen_exchange_database

    over = {"SYNTHETIC": {"NUM_SCENES": 4, "KEYFRAMES_PER_SCENE": 2, "NUM_CARS": 3,
                          "NUM_PEDS": 0},
            "MAX_POINTS_PER_SAMPLE": 2048,
            "POINT_CLOUD_RANGE": [-12.8, -12.8, -8.0, 12.8, 12.8, 0.0],
            "MINI_TRAINVAL_STRIDE": 1, "DATASET_DOWNSAMPLING_RATIO": 1}
    cfg, _, _ = build(CFG_CAR, device="cpu")
    cfg.DATA_CONFIG.update(over)
    from pcp_tpu_torch.models import DatasetInfo, build_network

    model = build_network(cfg.MODEL, 1, DatasetInfo.from_data_cfg(cfg.DATA_CONFIG, ["car"]),
                          device="cpu")
    init_weights(model, 0)
    with torch.no_grad():  # a seg bias that sends points as foreground
        model.corrector.point_head.seg[-1].bias.copy_(torch.tensor([-3.0, 3.0, 0.0]))
    written = gen_exchange_database("car", synthetic=True, out_dir=tmp_path,
                                    cfg_overrides=over, state_dict=model.state_dict(),
                                    device="cpu", workers=0)
    assert written == {"train": 2 * 2 * 5, "test": 2 * 2 * 5}  # scenes 1, 2 and 0, 3
    scenes = {int(f.name.split("_")[0][5:]) for f in tmp_path.glob("*_foreground.npz")}
    assert any(s % 3 != 0 for s in scenes), f"no train-split exchange files: {scenes}"
    assert any(s % 3 == 0 for s in scenes), f"no val-split exchange files: {scenes}"


def test_not_ported_raise_naming_their_item():
    from pcp_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor
    from pcp_tpu_torch.datasets.v2x_sim.source import NuScenesV2XSource

    # KITTI and the custom dataset are ported: without their infos they
    # raise naming the function that builds them
    _, tcfg = cfg_pair("v2x_sim_dataset_ego_early")
    tcfg.DATA_SPLIT = {"train": "train", "test": "val"}
    for name, builder in (("KittiDataset", "create_kitti_infos"),
                          ("CustomDataset", "create_custom_infos")):
        tcfg.DATASET = name
        with pytest.raises(FileNotFoundError, match=builder):
            build_dataloader(tcfg, ["car"], batch_size=1, training=False, workers=0)
    # the real V2X-Sim source is ported; without the devkit, and without a
    # database handed to it, it raises as the JAX package's does
    with pytest.raises(ImportError, match="nuscenes-devkit"):
        NuScenesV2XSource("data", "v2.0-trainval")
    # gt_sampling is ported; the local augmentations are not
    for name in ("random_local_rotation", "random_local_pyramid_aug"):
        with pytest.raises(NotImplementedError, match="A11.5"):
            DataAugmentor(None, {"DISABLE_AUG_LIST": [], "AUG_CONFIG_LIST": [{"NAME": name}]},
                          ["car"])
