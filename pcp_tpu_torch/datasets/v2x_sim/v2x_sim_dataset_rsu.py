"""V2X-Sim roadside unit (RSU, LIDAR_TOP_id_0) single-agent dataset.

Counterpart of ``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_rsu.py``: the
town-based train/val split (towns 4 and 5 train, town 3 val), the infos,
pseudo-sweep items, fixed-shape predictions to per-sample annotations, and
the nuScenes-protocol evaluation keyed by lidar token. The data come from
the synthetic world (``source.py``), or from the real V2X-Sim database
(present when ``{VERSION}/sample.json`` lies under the data root) through
``NuScenesV2XSource``; a ``source`` handed in is used as given. On the real
database :meth:`V2XSimDataset_RSU.build_v2x_sim_info` writes the split
(``{prefix}_trainval_split.pkl``) and the info pickles
(``{prefix}_v2x_sim_infos_{N}sweeps_{train,val}.pkl``, prefix ``mini`` or
``full`` after the version) that the dataset reads back, semantic-lidar
channels left out.
"""
import copy
import pickle
from pathlib import Path

import numpy as np

from ...config import ROOT_DIR
from ..dataset import DatasetTemplate
from ..eval.detection_metrics import nuscenes_protocol_eval
from .source import NuScenesV2XSource, SyntheticV2XSource
from .v2x_sim_utils import get_pseudo_sweeps_of_1lidar


def synthetic_source(dataset_cfg):
    """The ``SyntheticV2XSource`` that ``DATA_CONFIG.SYNTHETIC`` describes."""
    syn = dataset_cfg.get("SYNTHETIC", {})
    return SyntheticV2XSource(
        num_scenes=int(syn.get("NUM_SCENES", 4)),
        keyframes_per_scene=int(syn.get("KEYFRAMES_PER_SCENE", 12)),
        num_cars=int(syn.get("NUM_CARS", 24)),
        num_peds=int(syn.get("NUM_PEDS", 8)),
        seed=int(syn.get("SEED", 0)),
        world=str(syn.get("WORLD", "open")),
        num_parked=int(syn.get("NUM_PARKED", 0)),
        visible_faces=bool(syn.get("VISIBLE_FACES", False)),
        car_profile=(bool(syn["CAR_PROFILE"]) if "CAR_PROFILE" in syn else None),
    )


class V2XSimDataset_RSU(DatasetTemplate):
    LIDAR_IDS = (0,)

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None,
                 source=None):
        root_path = Path(root_path) if root_path is not None else Path(dataset_cfg["DATA_PATH"])
        if not root_path.is_absolute():
            # the reference's paths (../data/v2x-sim, from tools/) are taken
            # from the repository root, never from the working directory
            stripped = str(root_path)
            while stripped.startswith("../"):
                stripped = stripped[3:]
            root_path = ROOT_DIR / stripped
        root_path = root_path / dataset_cfg["VERSION"]
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self._prefix = "mini" if "mini" in dataset_cfg["VERSION"] else "full"

        self.classes_of_interest = set(dataset_cfg.get("CLASSES_OF_INTEREST", ["car", "pedestrian"]))
        self.num_historical_sweeps = int(dataset_cfg.get("NUM_HISTORICAL_SWEEPS", 10))
        self.num_sweeps = self.num_historical_sweeps + 1
        self.threshold_boxes_by_points = dataset_cfg.get("THRESHOLD_BOXES_BY_POINTS", 5)

        real_db_present = (self.root_path / dataset_cfg["VERSION"] / "sample.json").exists()
        self.synthetic = bool(dataset_cfg.get("USE_SYNTHETIC_DATA", False)) or not real_db_present
        if source is not None:
            self.source = source
            self.synthetic = isinstance(source, SyntheticV2XSource)
        elif self.synthetic:
            self.source = synthetic_source(dataset_cfg)
            if logger is not None:
                logger.info("V2X-Sim data not found -> synthetic V2X world active")
        else:
            self.source = NuScenesV2XSource(self.root_path, dataset_cfg["VERSION"])

        self.infos = []
        self.include_v2x_sim_data(self.mode)

    # ------------------------------------------------------------------ infos
    def _split_for_scene(self, scene):
        return "train" if scene.town in (4, 5) else "val"

    def _build_infos_synthetic(self, split):
        infos = []
        for scene, kf in self.source.iter_samples():
            if self._split_for_scene(scene) != split:
                continue
            for lidar_id in self.LIDAR_IDS:
                token = self.source.lidar_token(scene, kf, lidar_id)
                infos.append({"token": self.source.sample_token(scene, kf),
                              "lidar_token": token,
                              "lidar_id": lidar_id,
                              "lidar_path": f"{token}.bin",
                              "timestamp": int(kf * 1e6),
                              "glob_se3_lidar": self.source.get_pose(token)})
        return infos

    def include_v2x_sim_data(self, mode):
        if self.synthetic:
            self.infos = self._build_infos_synthetic(self.dataset_cfg["DATA_SPLIT"][mode])
        else:
            for info_path in self.dataset_cfg["INFO_PATH"][mode]:
                p = self.root_path / f"{self._prefix}_{info_path}"
                if p.exists():
                    with open(p, "rb") as f:
                        self.infos.extend(pickle.load(f))
            self.infos = self._filter_sem(self.infos)
        self.infos.sort(key=lambda e: e["timestamp"])
        stride = int(self.dataset_cfg.get("MINI_TRAINVAL_STRIDE", 1))
        if self.training and stride > 1:
            self.infos = self.infos[::stride]
        if self.logger is not None:
            self.logger.info("Total samples for V2X-Sim dataset: %d" % len(self.infos))

    def _filter_sem(self, infos):
        """Leave out the semantic-lidar channels (a ``SEM`` in the channel
        name)."""
        if not hasattr(self.source, "nusc"):
            return infos
        kept = []
        for info in infos:
            try:
                ch = self.source.nusc.get("sample_data", info["lidar_token"]).get("channel", "")
            except (KeyError, AttributeError):
                ch = ""
            if "SEM" not in ch:
                kept.append(info)
        return kept

    # ------------------------------------------------- raw-DB info building
    def _build_train_val_split(self):
        """The scene split by the log's town (4 and 5 train, else val),
        written to ``{prefix}_trainval_split.pkl``; a mini version puts the
        train scenes (or, lacking them, the val scenes) in both splits."""
        nusc = self.source.nusc
        train_scenes, val_scenes = [], []
        for scene in nusc.scene:
            log = nusc.get("log", scene["log_token"])
            if log["location"] in (4, 5, "4", "5"):
                train_scenes.append(scene["token"])
            else:
                val_scenes.append(scene["token"])
        if "mini" not in self.dataset_cfg["VERSION"]:
            trainval = {"train": set(train_scenes), "val": val_scenes}
        else:
            toks = train_scenes if train_scenes else val_scenes
            trainval = {"train": set(toks), "val": toks}
        path = self.root_path / f"{self._prefix}_trainval_split.pkl"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(trainval, f)
        return trainval

    def _load_trainval_split(self):
        path = self.root_path / f"{self._prefix}_trainval_split.pkl"
        if not path.exists():
            return self._build_train_val_split()
        with open(path, "rb") as f:
            return pickle.load(f)

    def _info_of_lidar_token(self, sample, lidar_token, threshold_boxes_by_points):
        """One info: the lidar's pose, gt boxes, names and their point
        counts in its own frame, its file and timestamp."""
        nusc = self.source.nusc
        frame = self.source.get_frame(lidar_token,
                                      classes_of_interest=tuple(self.classes_of_interest),
                                      threshold_boxes_by_points=threshold_boxes_by_points)
        sd = nusc.get("sample_data", lidar_token)
        return {"token": sample["token"],
                "lidar_token": lidar_token,
                "glob_se3_lidar": frame["glob_se3_lidar"],
                "gt_boxes": frame["boxes"],
                "gt_names": frame["names"],
                "num_points_in_boxes": frame["num_points_in_boxes"],
                "lidar_path": nusc.get_sample_data_path(lidar_token),
                "timestamp": sd["timestamp"]}

    def build_v2x_sim_info(self):
        """Write ``{prefix}_v2x_sim_infos_{N}sweeps_{train,val}.pkl`` of the
        RSU's lidar (``LIDAR_TOP_id_0``), a split left out where it has no
        sample; returns (train infos, val infos). Needs the real database or
        an object with the devkit's interface."""
        assert not self.synthetic, "info building needs a (possibly mocked) V2X-Sim DB"
        trainval = self._load_trainval_split()
        nusc = self.source.nusc
        lidar_name = "LIDAR_TOP_id_0"
        train_infos, val_infos = [], []
        for sample in nusc.sample:
            if lidar_name not in sample["data"]:
                continue
            info = self._info_of_lidar_token(sample, sample["data"][lidar_name],
                                             self.dataset_cfg.get("THRESHOLD_BOXES_BY_POINTS", 5))
            (train_infos if sample["scene_token"] in trainval["train"] else val_infos).append(info)
        for split, infos in (("train", train_infos), ("val", val_infos)):
            if not infos:
                continue
            p = self.root_path / f"{self._prefix}_v2x_sim_infos_{self.num_historical_sweeps}sweeps_{split}.pkl"
            with open(p, "wb") as f:
                pickle.dump(infos, f)
            if self.logger is not None:
                self.logger.info(f"v2x-sim infos {split}: {len(infos)} -> {p}")
        return train_infos, val_infos

    def __len__(self):
        return len(self.infos)

    # --------------------------------------------------------------- getitem
    def get_item(self, index, rng):
        info = copy.deepcopy(self.infos[index])
        stuff = get_pseudo_sweeps_of_1lidar(
            self.source, info["lidar_token"], self.num_historical_sweeps,
            self.classes_of_interest,
            points_in_boxes_by_gpu=self.dataset_cfg.get("POINTS_IN_BOXES_GPU", False),
            threshold_boxes_by_points=self.threshold_boxes_by_points)
        input_dict = {
            "points": stuff["points"],
            "gt_boxes": stuff["gt_boxes"],
            "gt_names": stuff["gt_names"],
            "instances_tf": stuff["instances_tf"],
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"lidar_token": info["lidar_token"],
                         "num_sweeps_target": self.num_sweeps,
                         "sample_token": info["token"],
                         "lidar_id": info.get("lidar_id", 0)},
        }
        return self.prepare_data(input_dict, rng)

    # ------------------------------------------------------------ prediction
    def generate_prediction_dicts(self, batch_dict, final_box_dicts, class_names):
        """Fixed-shape outputs (numpy, ``pred_valid`` masking) -> one
        annotation dict per sample."""
        boxes = np.asarray(final_box_dicts["pred_boxes"])
        scores = np.asarray(final_box_dicts["pred_scores"])
        labels = np.asarray(final_box_dicts["pred_labels"])
        valid = np.asarray(final_box_dicts["pred_valid"])
        annos = []
        for i in range(boxes.shape[0]):
            v = valid[i]
            lab = labels[i][v].astype(np.int64)
            annos.append({"boxes_lidar": boxes[i][v], "score": scores[i][v], "pred_labels": lab,
                          "name": np.array([class_names[j - 1] for j in lab]),
                          "metadata": batch_dict["metadata"][i]})
        return annos

    # ------------------------------------------------------------ evaluation
    def evaluation(self, det_annos, class_names, **kwargs):
        if kwargs.get("eval_metric", "nuscenes") != "nuscenes":
            raise NotImplementedError
        gt_by_token = {}
        for info in self.infos:
            if "gt_boxes" in info:
                gt_by_token[info["lidar_token"]] = {
                    "boxes": np.asarray(info["gt_boxes"])[:, :7],
                    "names": np.asarray(info["gt_names"]), "velocities": None}
            else:
                frame = self.source.get_frame(
                    info["lidar_token"], classes_of_interest=tuple(self.classes_of_interest),
                    threshold_boxes_by_points=self.threshold_boxes_by_points)
                gt_by_token[info["lidar_token"]] = {
                    "boxes": frame["boxes"], "names": frame["names"],
                    "velocities": (frame["boxes"][:, :2] - frame["prev_boxes"][:, :2]) / 0.2}
        return nuscenes_protocol_eval(det_annos, gt_by_token, class_names,
                                      output_path=kwargs.get("output_path"))
