"""The self-labelled custom dataset: counterpart of
``pcp_tpu/datasets/custom/custom_dataset.py``.

Points in ``points/<id>.npy``, labels in ``labels/<id>.txt`` (``x y z dx dy
dz heading class`` per line, lidar frame), split lists in ``ImageSets/``.
At run time it reads the info pickles that :func:`create_custom_infos`
writes; the evaluation maps the classes through ``MAP_CLASS_TO_KITTI`` and
runs KITTI's official AP on pseudo camera annotations
(``kitti/kitti_utils.py::transform_annotations_to_kitti_format``).
"""
import copy
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate
from ..kitti.kitti_dataset import resolve_root


class CustomDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        root_path = resolve_root(root_path if root_path is not None else dataset_cfg["DATA_PATH"])
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = ([x.strip() for x in open(split_file).readlines()]
                               if split_file.exists() else None)
        self.custom_infos = []
        self.include_data(self.mode)
        self.map_class_to_kitti = dataset_cfg.get("MAP_CLASS_TO_KITTI", {})

    def include_data(self, mode):
        for info_path in self.dataset_cfg.get("INFO_PATH", {}).get(mode, []):
            p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.custom_infos.extend(pickle.load(f))
        if self.logger is not None:
            self.logger.info(f"Total samples for CUSTOM dataset: {len(self.custom_infos)}")
        if not self.custom_infos:
            raise FileNotFoundError(f"no custom infos under {self.root_path}: run "
                                    "create_custom_infos first")

    def get_lidar(self, idx):
        return np.load(str(self.root_path / "points" / f"{idx}.npy"))

    def get_label(self, idx):
        boxes, names = [], []
        for line in open(self.root_path / "labels" / f"{idx}.txt").readlines():
            parts = line.strip().split(" ")
            if not parts or not parts[0]:
                continue
            boxes.append([float(v) for v in parts[:-1]])
            names.append(parts[-1])
        return np.array(boxes, np.float32).reshape(-1, 7), np.array(names)

    def __len__(self):
        return len(self.custom_infos)

    def get_item(self, index, rng):
        info = copy.deepcopy(self.custom_infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        input_dict = {"frame_id": sample_idx, "points": self.get_lidar(sample_idx),
                      "metadata": {"frame_id": sample_idx}}
        if "annos" in info:
            annos = info["annos"]
            keep = np.asarray(annos["name"]) != "DontCare"
            input_dict["gt_names"] = np.asarray(annos["name"])[keep]
            input_dict["gt_boxes"] = np.asarray(annos["gt_boxes_lidar"], np.float64)[keep]
        return self.prepare_data(input_dict, rng)

    def generate_prediction_dicts(self, batch_dict, final_box_dicts, class_names,
                                  output_path=None):
        annos = []
        for i in range(batch_dict["batch_size"]):
            valid = np.asarray(final_box_dicts["pred_valid"][i])
            boxes = np.asarray(final_box_dicts["pred_boxes"][i])[valid][:, :7]
            labels = np.asarray(final_box_dicts["pred_labels"][i])[valid]
            annos.append({
                "name": (np.array(class_names, dtype=object)[labels - 1] if boxes.shape[0]
                         else np.zeros(0, dtype=object)),
                "score": np.asarray(final_box_dicts["pred_scores"][i])[valid],
                "boxes_lidar": boxes, "pred_labels": labels,
                "frame_id": batch_dict["metadata"][i]["frame_id"]})
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        if "annos" not in self.custom_infos[0]:
            return "No ground-truth boxes for evaluation", {}
        from ..kitti import kitti_utils
        from ..kitti.kitti_eval import eval as kitti_eval

        eval_det = copy.deepcopy(det_annos)
        eval_gt = [copy.deepcopy(info["annos"]) for info in self.custom_infos]
        kitti_utils.transform_annotations_to_kitti_format(
            eval_det, map_name_to_kitti=self.map_class_to_kitti)
        kitti_utils.transform_annotations_to_kitti_format(
            eval_gt, map_name_to_kitti=self.map_class_to_kitti,
            info_with_fakelidar=self.dataset_cfg.get("INFO_WITH_FAKELIDAR", False))
        kitti_classes = [self.map_class_to_kitti[x] for x in class_names]
        return kitti_eval.get_official_eval_result(eval_gt, eval_det, kitti_classes)

    def get_infos(self, class_names, has_label=True, sample_id_list=None, num_features=4):
        infos = []
        for sample_idx in (sample_id_list or self.sample_id_list or []):
            info = {"point_cloud": {"num_features": num_features, "lidar_idx": sample_idx}}
            if has_label:
                boxes, names = self.get_label(sample_idx)
                info = {**info, "annos": {"name": names, "gt_boxes_lidar": boxes[:, :7]}}
            infos.append(info)
        return infos

    def create_groundtruth_database(self, info_path=None, used_classes=None, split="train"):
        """One box-centred ``.bin`` per object and ``custom_dbinfos_{split}.pkl``."""
        from ..augmentor.gt_database import create_groundtruth_database

        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        return create_groundtruth_database(infos, self.get_lidar, self.root_path, "custom",
                                           used_classes=used_classes, split=split,
                                           logger=self.logger)


def create_custom_infos(dataset_cfg, class_names, data_path, save_path, with_gt_database=True):
    """``custom_infos_{train,val}.pkl`` under ``save_path`` for the splits
    whose ``ImageSets`` file exists, and the train gt database."""
    dataset = CustomDataset.__new__(CustomDataset)
    DatasetTemplate.__init__(dataset, dataset_cfg, class_names, False, data_path, None)
    for split in ("train", "val"):
        ids_file = Path(data_path) / "ImageSets" / f"{split}.txt"
        if not ids_file.exists():
            continue
        dataset.sample_id_list = [x.strip() for x in open(ids_file).readlines()]
        infos = dataset.get_infos(class_names)
        out = Path(save_path) / f"custom_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"custom infos {split}: {len(infos)} -> {out}")
        if split == "train" and with_gt_database:
            dataset.create_groundtruth_database(info_path=out, split=split)
