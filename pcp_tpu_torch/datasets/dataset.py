"""Dataset template: augment -> encode -> process, and the padded collate.

Counterpart of ``pcp_tpu/datasets/dataset.py``. ``collate_batch`` pads every
sample to fixed capacities (``MAX_POINTS_PER_SAMPLE``, ``MAX_GT_PER_SAMPLE``,
``MAX_INSTANCES``) and emits dense (B, N, C) arrays with boolean masks, the
batch layout of both packages' models.

Randomness: every draw of a sample (augmentation, shuffle, the resampling of
a training sample without ground truth) comes from the
``np.random.RandomState`` handed to ``get_item``, in the order the JAX
package draws from numpy's global generator; seeded alike, both give the
same sample. ``dataset[i]`` draws from ``dataset.rng``; the loader
(``loader.py``) hands each item a generator of its own.
"""
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils import common_utils
from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder

DEFAULT_MAX_POINTS = 65536
DEFAULT_MAX_GT = 500
DEFAULT_MAX_INSTANCES = 256


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True, root_path=None,
                 logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None else dataset_cfg["DATA_PATH"])
        self.rng = np.random.RandomState()
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(self.dataset_cfg["POINT_CLOUD_RANGE"], dtype=np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg["POINT_FEATURE_ENCODING"], point_cloud_range=self.point_cloud_range)
        self.data_augmentor = (
            DataAugmentor(self.root_path, self.dataset_cfg["DATA_AUGMENTOR"], self.class_names,
                          logger=logger)
            if self.training and self.dataset_cfg.get("DATA_AUGMENTOR") is not None else None)
        self.data_processor = DataProcessor(
            self.dataset_cfg["DATA_PROCESSOR"], point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size

        self.max_points = int(self.dataset_cfg.get("MAX_POINTS_PER_SAMPLE", DEFAULT_MAX_POINTS))
        self.max_gt = int(self.dataset_cfg.get("MAX_GT_PER_SAMPLE", DEFAULT_MAX_GT))
        self.max_instances = int(self.dataset_cfg.get("MAX_INSTANCES", DEFAULT_MAX_INSTANCES))

    @property
    def mode(self):
        return "train" if self.training else "test"

    def __len__(self):
        raise NotImplementedError

    def get_item(self, index, rng):
        raise NotImplementedError

    def __getitem__(self, index):
        return self.get_item(index, self.rng)

    def prepare_data(self, data_dict, rng):
        """Augment (training) -> keep the gt of ``class_names`` -> encode the
        point features -> the processor queue. A training sample left with
        no gt of the classes of interest is replaced by a random one."""
        if self.training:
            assert "gt_boxes" in data_dict, "gt_boxes should be provided for training"
            gt_boxes_mask = np.array([n in self.class_names for n in data_dict["gt_names"]],
                                     dtype=np.bool_)
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor.forward(
                    {**data_dict, "gt_boxes_mask": gt_boxes_mask}, rng)

        if data_dict.get("gt_boxes", None) is not None:
            selected = common_utils.keep_arrays_by_name(data_dict["gt_names"], self.class_names)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            # instances_tf is not filtered: points' inst_idx indexes its rows
            # in the original instance order
            names = data_dict["gt_names"]
            data_dict["gt_names"] = (names[selected] if isinstance(names, np.ndarray)
                                     else np.array([names[i] for i in selected]))
            gt_classes = np.array([self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                                  dtype=np.int32)
            data_dict["gt_boxes"] = np.concatenate(
                (data_dict["gt_boxes"], gt_classes.reshape(-1, 1).astype(np.float32)), axis=1)
            if self.training and data_dict["gt_boxes"].shape[0] == 0:
                return self.get_item(rng.randint(len(self)), rng)

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)

        data_dict = self.data_processor.forward(data_dict, rng)

        if self.training:
            cls_of_interest = self.dataset_cfg.get(
                "VEHICLE_CLASSES", self.dataset_cfg.get("DETECTION_CLS", self.class_names))
            if not any(np.any(data_dict["gt_names"] == c) for c in cls_of_interest):
                return self.get_item(rng.randint(len(self)), rng)

        data_dict.pop("gt_names", None)
        return data_dict

    @staticmethod
    def _pad_rows(arr, capacity):
        n = arr.shape[0]
        if n >= capacity:
            return arr[:capacity], min(n, capacity)
        pad = np.zeros((capacity - n,) + arr.shape[1:], dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=0), n

    def collate_batch(self, batch_list):
        """Pad each sample to the fixed capacities. Keys produced:
        ``points`` (B, Np, C) float32 and ``points_mask`` (B, Np) bool (a
        cloud longer than Np keeps its first Np rows: they were shuffled),
        ``gt_boxes`` (B, Ng, 7+1) zero-padded, ``instances_tf`` (B, Ni,
        n_sweeps, 4, 4), ``metadata`` (a list of per-sample dicts) and
        ``batch_size``; other keys stacked."""
        data_dict = defaultdict(list)
        for cur_sample in batch_list:
            for key, val in cur_sample.items():
                data_dict[key].append(val)
        batch_size = len(batch_list)
        ret = {"batch_size": batch_size}

        for key, val in data_dict.items():
            if key == "points":
                pts, masks = [], []
                for p in val:
                    padded, n = self._pad_rows(p[:self.max_points].astype(np.float32),
                                               self.max_points)
                    mask = np.zeros(self.max_points, dtype=bool)
                    mask[:n] = True
                    pts.append(padded)
                    masks.append(mask)
                ret["points"] = np.stack(pts)
                ret["points_mask"] = np.stack(masks)
            elif key == "gt_boxes":
                width = max(v.shape[1] if v.ndim == 2 else 0 for v in val)
                out = np.zeros((batch_size, self.max_gt, width), dtype=np.float32)
                for i, v in enumerate(val):
                    n = min(v.shape[0], self.max_gt)
                    if n:
                        out[i, :n] = v[:n]
                ret[key] = out
            elif key == "instances_tf":
                if all(v is None or v.size == 0 for v in val):
                    continue
                n_sweeps = max(v.shape[1] for v in val if v is not None and v.size)
                out = np.zeros((batch_size, self.max_instances, n_sweeps, 4, 4), dtype=np.float32)
                for i, v in enumerate(val):
                    if v is None or v.size == 0:
                        continue
                    n = min(v.shape[0], self.max_instances)
                    out[i, :n] = v[:n]
                ret[key] = out
            elif key in ("metadata", "frame_id", "use_lead_xyz", "gt_names"):
                ret[key] = val if key == "metadata" else np.array(val, dtype=object)
            elif key in ("flip_x", "flip_y", "noise_rot", "noise_scale"):
                ret[key] = np.array(val)
            else:
                try:
                    ret[key] = np.stack(val, axis=0)
                except (ValueError, TypeError):
                    ret[key] = val
        return ret
