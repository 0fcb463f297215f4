"""The real V2X-Sim info building of the port against the JAX package's.

Both packages read the fake V2X-Sim database of
``tests/torch_fake_devkit.py`` (the schema of ``test_info_builders.py``:
towns 4 and 3, three keyframes, lidars id_0..id_2 and a semantic channel)
through ``NuScenesV2XSource`` with the database handed in, each writing into
its own data root. Held exactly (numpy arrays equal in dtype, shape and
value): the train/val split pickle, the RSU's and the car's info pickles,
and items and batches built from those pickles, seeded alike
(``np.random.seed`` on the JAX side, the dataset's ``RandomState`` on the
port's). A source's instance ids are ``abs(hash(instance_token))``, which
Python salts per process; both packages run in this one process, so their
ids agree. Without the devkit and without a database handed in, both
sources raise ImportError.
"""
import pickle

import numpy as np
import pytest
import torch

from pcp_tpu.config import CfgDict as JaxCfg
from pcp_tpu.config import ROOT_DIR
from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from pcp_tpu.datasets.v2x_sim.source import NuScenesV2XSource as JaxSource
from pcp_tpu.datasets.v2x_sim.v2x_sim_dataset_car import V2XSimDataset_CAR as JaxCar
from pcp_tpu.datasets.v2x_sim.v2x_sim_dataset_rsu import V2XSimDataset_RSU as JaxRsu
from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
from pcp_tpu_torch.datasets import build_dataloader
from pcp_tpu_torch.datasets.v2x_sim.source import NuScenesV2XSource
from pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_car import V2XSimDataset_CAR
from pcp_tpu_torch.datasets.v2x_sim.v2x_sim_dataset_rsu import V2XSimDataset_RSU
from test_torch_datasets import assert_same
from torch_fake_devkit import make_v2x_db

CAR_INFOS = {"train": ["v2x_sim_car_infos_10sweeps_train.pkl"],
             "test": ["v2x_sim_car_infos_10sweeps_val.pkl"]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cfgs(root, version, car=False):
    """The RSU dataset config (the car's with ``car``) on the fake database
    at ``root``, for each package."""
    out = []
    for make, load in ((JaxCfg, jax_cfg_from_yaml), (CfgDict, cfg_from_yaml_file)):
        cfg = load(str(ROOT_DIR / "tools/cfgs/dataset_configs/v2x_sim_dataset_rsu.yaml"), make())
        cfg.update({"DATA_PATH": str(root), "VERSION": version, "USE_SYNTHETIC_DATA": False,
                    "MINI_TRAINVAL_STRIDE": 1, "THRESHOLD_BOXES_BY_POINTS": 1 if car else 5,
                    "MAX_POINTS_PER_SAMPLE": 4096})
        if car:
            cfg.INFO_PATH = dict(CAR_INFOS)
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Each package's infos built from its own copy of the fake database."""
    out = {}
    for pkg, (src_cls, rsu_cls, car_cls) in (("jax", (JaxSource, JaxRsu, JaxCar)),
                                             ("torch", (NuScenesV2XSource, V2XSimDataset_RSU,
                                                        V2XSimDataset_CAR))):
        root = tmp_path_factory.mktemp(pkg)
        fake, version = make_v2x_db(root)
        src = src_cls(root / version, version, nusc=fake)
        rsu_cfg, car_cfg = (c[pkg == "torch"] for c in (_cfgs(root, version),
                                                         _cfgs(root, version, car=True)))
        rsu = rsu_cls(rsu_cfg, ["car"], training=True, source=src)
        assert len(rsu.infos) == 0  # nothing built yet
        rsu_infos = rsu.build_v2x_sim_info()
        car_infos = car_cls.build_v2x_sim_info(car_cls(car_cfg, ["car"], training=True, source=src))
        out[pkg] = {"root": root / version, "src": src, "fake": fake, "rsu_cfg": rsu_cfg,
                    "car_cfg": car_cfg, "rsu_infos": rsu_infos, "car_infos": car_infos,
                    "classes": (rsu_cls, car_cls)}
    return out


def _pickle(root, name):
    with open(root / name, "rb") as f:
        return pickle.load(f)


def _portable(infos):
    """The infos with the data root taken out of each ``lidar_path``."""
    def strip(info):
        return dict(info, lidar_path=info["lidar_path"].split("v2.0-trainval/")[-1])
    if isinstance(infos, dict):
        return {k: [strip(i) for i in v] for k, v in infos.items()}
    return [strip(i) for i in infos]


def test_split_pickle_equals_jax(built):
    j, t = (_pickle(built[p]["root"], "full_trainval_split.pkl") for p in ("jax", "torch"))
    assert j == t == {"train": {"sc0"}, "val": ["sc1"]}


@pytest.mark.parametrize("name", ["full_v2x_sim_infos_10sweeps_train.pkl",
                                  "full_v2x_sim_infos_10sweeps_val.pkl",
                                  "full_v2x_sim_car_infos_10sweeps_train.pkl",
                                  "full_v2x_sim_car_infos_10sweeps_val.pkl"])
def test_info_pickles_equal_jax(built, name):
    j, t = (_portable(_pickle(built[p]["root"], name)) for p in ("jax", "torch"))
    assert_same(j, t)
    infos = t if isinstance(t, list) else [i for v in t.values() for i in v]
    assert infos and all(i["gt_boxes"].shape[1] == 7 for i in infos)
    if isinstance(t, dict):  # the car's: lidars 1 and 2 in the database, 3-5 empty
        assert [len(t[k]) for k in range(1, 6)] == [3, 3, 0, 0, 0]


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("car", [False, True], ids=["rsu", "car"])
def test_items_from_pickles_equal_jax(built, car, training):
    """Datasets built anew read the pickles back (the car's without its
    semantic channel); their items and a batch equal the JAX package's."""
    dsets = {}
    for pkg in ("jax", "torch"):
        b = built[pkg]
        cls = b["classes"][car]
        dsets[pkg] = cls(b["car_cfg" if car else "rsu_cfg"], ["car"], training=training,
                         source=b["src"])
    jds, tds = dsets["jax"], dsets["torch"]
    assert len(jds) == len(tds) == (6 if car else 3)
    assert all("SEM" not in built["torch"]["fake"].get("sample_data", i["lidar_token"])["channel"]
               for i in tds.infos)
    np.random.seed(5)
    tds.rng = np.random.RandomState(5)
    jitems = [jds[i] for i in range(len(jds))]
    titems = [tds[i] for i in range(len(tds))]
    for a, b in zip(jitems, titems):
        assert_same(a, b)
        assert b["points"].shape[0] > 0 and b["gt_boxes"].shape[0] >= 1
    assert_same(jds.collate_batch(jitems[:2]), tds.collate_batch(titems[:2]))


def test_build_dataloader_takes_the_source(built):
    """``build_dataloader(source=...)`` hands the source to the car's
    dataset, as the JAX package's does."""
    b = built["torch"]
    cfg = CfgDict(dict(b["car_cfg"], DATASET="V2XSimDataset_CAR"))
    ds, loader, _ = build_dataloader(cfg, ["car"], batch_size=2, training=False, workers=0,
                                     source=b["src"])
    assert ds.source is b["src"] and not ds.synthetic and len(ds) == 6
    batch = next(iter(loader))
    assert batch["points"].shape[0] == 2 and batch["points_mask"].any()


def test_without_devkit_both_raise_import_error():
    for cls in (JaxSource, NuScenesV2XSource):
        with pytest.raises(ImportError, match="nuscenes-devkit"):
            cls("data", "v2.0-trainval")


def test_detection_names_equal_jax():
    from pcp_tpu.datasets.v2x_sim.source import _detection_name as jax_name
    from pcp_tpu_torch.datasets.v2x_sim.source import _detection_name

    for cat in ("vehicle.car", "human.pedestrian.adult", "vehicle.truck", "vehicle.bus.rigid",
                "vehicle.bicycle", "vehicle.motorcycle", "animal", "movable_object.barrier"):
        assert _detection_name(cat) == jax_name(cat)
