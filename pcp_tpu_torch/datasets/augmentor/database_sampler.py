"""The gt sampler: counterpart of ``pcp_tpu/datasets/augmentor/database_sampler.py``.

Pastes pre-extracted gt objects from the gt database (``gt_database.py``)
into a training scene: for each class of ``SAMPLE_GROUPS`` it takes the next
objects of a shuffled pool, removes the scene's points inside their boxes and
prepends their points. An object's points come from its ``.bin`` or, where
``DB_DATA_PATH`` names an integrated database, from that array's rows. The
pool's shuffle draws from the sample's ``np.random.RandomState``; the
per-class pointer and permutation persist across items, as in the JAX
package, so two runs agree item for item only in the same order.
"""
import pickle
from pathlib import Path

import numpy as np

from ...utils import box_utils


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.db_infos = {name: [] for name in class_names}
        for db_info_path in sampler_cfg.get("DB_INFO_PATH", []):
            path = self.root_path / db_info_path
            if not path.exists():
                if logger is not None:
                    logger.warning(f"gt database missing: {path}")
                continue
            with open(path, "rb") as f:
                infos = pickle.load(f)
            for cur_class in class_names:
                if cur_class in infos:
                    self.db_infos[cur_class].extend(infos[cur_class])

        self.gt_database_data = None
        db_data_path = sampler_cfg.get("DB_DATA_PATH", [])
        if db_data_path:
            path = self.root_path / db_data_path[0]
            if path.exists():
                self.gt_database_data = np.load(str(path), mmap_mode="r")
            elif logger is not None:
                logger.warning(f"integrated gt database missing: {path}")

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        for x in sampler_cfg.get("SAMPLE_GROUPS", []):
            class_name, sample_num = x.split(":")
            if class_name in class_names:
                self.sample_groups[class_name] = {
                    "sample_num": int(sample_num),
                    "pointer": len(self.db_infos[class_name]),
                    "indices": np.arange(len(self.db_infos[class_name])),
                }

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [x for x in db_infos[name] if x["num_points_in_gt"] >= min_num]
        return db_infos

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        for key in db_infos:
            db_infos[key] = [x for x in db_infos[key]
                             if x.get("difficulty", 0) not in removed_difficulty]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group, rng):
        sample_num = sample_group["sample_num"]
        pool = len(self.db_infos[class_name])
        if pool == 0:
            return []
        if sample_group["pointer"] + sample_num >= pool:
            sample_group["indices"] = rng.permutation(pool)
            sample_group["pointer"] = 0
        idxs = sample_group["indices"][sample_group["pointer"]:sample_group["pointer"] + sample_num]
        sample_group["pointer"] += sample_num
        return [self.db_infos[class_name][i] for i in idxs]

    def _object_points(self, info):
        """An object's points, box-centred; None where its file is missing."""
        if self.gt_database_data is not None and "global_data_offset" in info:
            start, end = info["global_data_offset"]
            return np.array(self.gt_database_data[start:end], dtype=np.float32)
        file_path = self.root_path / info["path"]
        if not file_path.exists():
            return None
        return np.fromfile(str(file_path), dtype=np.float32).reshape(
            -1, self.sampler_cfg.get("NUM_POINT_FEATURES", 4))

    def __call__(self, data_dict, rng):
        """Paste objects into ``data_dict``. A class with at least its
        ``SAMPLE_GROUPS`` count of gt is skipped; otherwise its group's full
        count is drawn, as the JAX package draws it."""
        gt_boxes, gt_names, points = data_dict["gt_boxes"], data_dict["gt_names"], data_dict["points"]
        boxes, clouds, names = [], [], []
        for class_name, sample_group in self.sample_groups.items():
            num_existing = int((gt_names == class_name).sum())
            if sample_group["sample_num"] - num_existing <= 0:
                continue
            for info in self.sample_with_fixed_number(class_name, sample_group, rng):
                obj_points = self._object_points(info)
                if obj_points is None:
                    continue
                obj_points[:, :3] += info["box3d_lidar"][:3]
                boxes.append(info["box3d_lidar"])
                clouds.append(obj_points)
                names.append(class_name)

        if boxes:
            sampled_boxes = np.stack(boxes, axis=0)[:, :7]
            points = box_utils.remove_points_in_boxes(points, sampled_boxes)
            sp = np.concatenate(clouds, axis=0)
            if sp.shape[1] < points.shape[1]:
                sp = np.hstack([sp, np.zeros((sp.shape[0], points.shape[1] - sp.shape[1]),
                                             dtype=sp.dtype)])
            data_dict["points"] = np.concatenate([sp[:, :points.shape[1]], points], axis=0)
            data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_boxes], axis=0)
            data_dict["gt_names"] = np.concatenate([gt_names, np.array(names)])
        return data_dict
