"""Host-side data processor queue: counterpart of
``pcp_tpu/datasets/processor/data_processor.py``.

The config's ``DATA_PROCESSOR`` steps run in order on each sample dict. The
V2X configs use three: the range mask, the shuffle and the voxelization
placeholder (grid bookkeeping only: the VFE voxelizes on the device);
PointRCNN's adds ``sample_points``. A step that draws takes the sample's
``np.random.RandomState``.
"""
from functools import partial

import numpy as np

from ...utils import box_utils


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training, num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = self.voxel_size = None
        self.data_processor_queue = [getattr(self, c["NAME"])(config=c) for c in processor_configs]

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        if data_dict.get("points", None) is not None:
            mask = box_utils.mask_points_by_range(data_dict["points"], self.point_cloud_range)
            data_dict["points"] = data_dict["points"][mask]
        if (data_dict.get("gt_boxes", None) is not None
                and config.get("REMOVE_OUTSIDE_BOXES", False) and self.training):
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict["gt_boxes"], self.point_cloud_range,
                min_num_corners=config.get("min_num_corners", 1))
            data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
            tf = data_dict.get("instances_tf", None)
            if tf is not None and tf.shape[0] == mask.shape[0]:
                data_dict["instances_tf"] = tf[mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config["SHUFFLE_ENABLED"][self.mode]:
            points = data_dict["points"]
            data_dict["points"] = points[rng.permutation(points.shape[0])]
        return data_dict

    def _grid_from(self, config):
        grid_size = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / np.array(
            config["VOXEL_SIZE"])
        self.grid_size = np.round(grid_size).astype(np.int64)
        self.voxel_size = config["VOXEL_SIZE"]

    def transform_points_to_voxels_placeholder(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            self._grid_from(config)
            return partial(self.transform_points_to_voxels_placeholder, config=config)
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None, rng=None):
        """Hard voxelization: the V2X models voxelize on the device, so this
        keeps the grid bookkeeping and passes the points through, as the JAX
        package does."""
        return self.transform_points_to_voxels_placeholder(data_dict, config, rng)

    def sample_points(self, data_dict=None, config=None, rng=None):
        """``NUM_POINTS[mode]`` points (-1: all): from a larger cloud every
        point past 40 m and a draw of the near ones (or a draw of all, where
        the far ones alone are enough), from a smaller one every point and a
        draw with replacement, then shuffled; the draws in the JAX package's
        order."""
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config["NUM_POINTS"][self.mode]
        if num_points == -1:
            return data_dict
        points = data_dict["points"]
        if num_points < len(points):
            pts_near_flag = np.linalg.norm(points[:, 0:3], axis=1) < 40.0
            far_idxs_choice = np.where(pts_near_flag == 0)[0]
            near_idxs = np.where(pts_near_flag == 1)[0]
            if num_points > len(far_idxs_choice):
                near_idxs_choice = rng.choice(near_idxs, num_points - len(far_idxs_choice),
                                              replace=False)
                choice = (np.concatenate((near_idxs_choice, far_idxs_choice), axis=0)
                          if len(far_idxs_choice) > 0 else near_idxs_choice)
            else:
                choice = rng.choice(np.arange(0, len(points), dtype=np.int32), num_points,
                                    replace=False)
            rng.shuffle(choice)
        else:
            choice = np.arange(0, len(points), dtype=np.int32)
            if num_points > len(points):
                extra_choice = rng.choice(choice, num_points - len(points), replace=True)
                choice = np.concatenate((choice, extra_choice), axis=0)
            rng.shuffle(choice)
        data_dict["points"] = points[choice]
        return data_dict

    def forward(self, data_dict, rng):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict, rng=rng)
        return data_dict
