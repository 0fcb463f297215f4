"""V2X-Sim ego dataset for DiscoNet mid fusion.

Counterpart of ``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_ego_disco.py``:
early-fusion clouds (the ego's pseudo-sweeps, then each other agent's moved
into the ego's lidar frame and appended) whose sixth column is the agent's
lidar id (the ego is 1) in place of the sweep and instance columns, so the
BEV makers can pick each agent's points. Each agent's pose relative to the
ego rides in the metadata (``se3_from_ego``, agent <- ego), which the world
augmentations update; after them the item gains ``se3_from_ego_arr``
(6, 4, 4) float32, identity for an absent agent, and ``agent_present`` (6,)
bool, the ego always present. ``EXCHANGE_PREVIOUS`` (async) takes the other
agents' clouds from the previous keyframe and drops the samples that have
none. The ground truth is the ego dataset's.
"""
import copy
from pathlib import Path

import numpy as np

from ...utils.geometry import apply_se3, se3_inverse
from .source import NUM_AGENTS
from .v2x_sim_dataset_ego import EGO_LIDAR_ID, V2XSimDataset_EGO
from .v2x_sim_utils import get_pseudo_sweeps_of_1lidar


class V2XSimDataset_EGO_DISCO(V2XSimDataset_EGO):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self.exchange_database = None  # mid fusion exchanges BEV features, not boxes
        self.exchange_previous = bool(dataset_cfg.get("EXCHANGE_PREVIOUS", False))
        if self.exchange_previous:
            self.infos = [info for info in self.infos
                          if self.source.sample_record(info["token"])["prev"] != ""]

    def get_item(self, index, rng):
        info = copy.deepcopy(self.infos[index])
        ego = get_pseudo_sweeps_of_1lidar(
            self.source, info["lidar_token"], self.num_historical_sweeps,
            self.classes_of_interest,
            threshold_boxes_by_points=self.dataset_cfg.get("THRESHOLD_BOXES_BY_POINTS", 5))
        points = ego["points"]
        points = np.concatenate([points[:, :5], np.ones((points.shape[0], 1)) * EGO_LIDAR_ID], axis=1)
        gt_boxes = info.get("gt_boxes", ego["gt_boxes"])
        gt_names = info.get("gt_names", ego["gt_names"])
        num_original = points.shape[0]

        target_se3_glob = se3_inverse(self.source.get_pose(info["lidar_token"]))
        sample = self.source.sample_record(info["token"])
        if self.exchange_previous:
            sample = self.source.sample_record(sample["prev"])
        exchange_metadata = {i: 0.0 for i in range(NUM_AGENTS) if i != EGO_LIDAR_ID}
        clouds, se3_from_ego = [points], {}
        for lidar_name, lidar_token in sample["data"].items():
            if not lidar_name.startswith("LIDAR_TOP_id_"):
                continue
            lidar_id = int(lidar_name.split("_")[-1])
            if lidar_id == EGO_LIDAR_ID:
                continue
            xpoints = get_pseudo_sweeps_of_1lidar(
                self.source, lidar_token, self.num_historical_sweeps, self.classes_of_interest,
                threshold_boxes_by_points=self.dataset_cfg.get("THRESHOLD_BOXES_BY_POINTS", 1),
            )["points"]
            xpoints = np.concatenate([xpoints[:, :5], np.zeros((xpoints.shape[0], 1)) + lidar_id],
                                     axis=1)
            target_se3_lidar = target_se3_glob @ self.source.get_pose(lidar_token)
            xpoints[:, :3] = apply_se3(target_se3_lidar, points=xpoints[:, :3])
            exchange_metadata[lidar_id] = xpoints.shape[0]
            clouds.append(xpoints)
            se3_from_ego[lidar_id] = se3_inverse(target_se3_lidar)

        input_dict = {
            "points": np.concatenate(clouds, axis=0) if len(clouds) > 1 else points,
            "gt_boxes": np.asarray(gt_boxes, dtype=np.float64)[:, :7],
            "gt_names": np.asarray(gt_names),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"lidar_token": info["lidar_token"],
                         "num_sweeps_target": self.num_sweeps,
                         "sample_token": info["token"],
                         "lidar_id": EGO_LIDAR_ID,
                         "num_original": num_original,
                         "exchange": exchange_metadata,
                         "se3_from_ego": se3_from_ego},
        }
        data_dict = self.prepare_data(input_dict, rng)
        # after the augmentations, which turn the ego frame and so every pose
        se3_arr = np.tile(np.eye(4, dtype=np.float32)[None], (NUM_AGENTS, 1, 1))
        present = np.zeros(NUM_AGENTS, dtype=bool)
        for lid, tf in data_dict["metadata"]["se3_from_ego"].items():
            se3_arr[lid] = tf.astype(np.float32)
            present[lid] = True
        present[EGO_LIDAR_ID] = True
        data_dict["se3_from_ego_arr"] = se3_arr
        data_dict["agent_present"] = present
        return data_dict
