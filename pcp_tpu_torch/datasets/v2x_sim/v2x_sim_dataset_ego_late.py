"""V2X-Sim ego dataset for late fusion (evaluation only): every agent's
predicted boxes, for ``V2XLateFusion`` to merge.

Counterpart of ``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_ego_late.py``: an
item holds a dummy point and, in ``metadata["exchange_boxes"]``, one (N, 9)
array a lidar id (box7, score, label, in the ego's lidar frame): the ego's
own broadcast at the current keyframe, and each other agent's at
``EXCHANGE_SETTING`` ``now`` (the current keyframe) or ``prev`` (the
previous one, advanced by its flow unless ``EXCHANGE_FLOW_PROPAGATION`` is
False). The ego dataset's levers ``EXCHANGE_ORACLE`` and
``EXCHANGE_ORACLE_FLOW`` apply to the other agents.
"""
import copy
from pathlib import Path

import numpy as np

from ...utils.geometry import apply_se3, se3_inverse
from .v2x_sim_dataset_ego import EGO_LIDAR_ID, V2XSimDataset_EGO


class V2XSimDataset_EGO_LATE(V2XSimDataset_EGO):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        if self.mode != "test":
            raise ValueError("late fusion only evaluates (training=False)")
        self.exchange_setting = dataset_cfg.get("EXCHANGE_SETTING", "prev")
        if self.exchange_setting not in ("now", "prev"):
            raise ValueError(f"EXCHANGE_SETTING := {self.exchange_setting} is unknown")

    def get_item(self, index, rng):
        info = copy.deepcopy(self.infos[index])
        gt_boxes = info.get("gt_boxes", np.zeros((0, 7)))
        gt_names = info.get("gt_names", np.zeros((0,), dtype="<U16"))

        ego_se3_glob = se3_inverse(self.source.get_pose(info["lidar_token"]))
        sample_token = info["token"]
        sample = self.source.sample_record(sample_token)

        ego_modar = self.exchange_database[EGO_LIDAR_ID].load(sample_token, EGO_LIDAR_ID, "modar")
        if ego_modar is None:
            ego_modar = np.zeros((0, 9))
        exchange_boxes = {EGO_LIDAR_ID: ego_modar}
        exchange_metadata = {EGO_LIDAR_ID: ego_modar.shape[0]}

        prev = self.exchange_setting == "prev"
        exch_token = sample["prev"] if prev else sample_token
        if exch_token != "":
            for lidar_name, lidar_token in self.source.sample_record(exch_token)["data"].items():
                if not lidar_name.startswith("LIDAR_TOP_id_"):
                    continue
                lidar_id = int(lidar_name.split("_")[-1])
                if lidar_id == EGO_LIDAR_ID:
                    continue
                modar, _ = self._load_and_propagate_modar(
                    exch_token, lidar_id, propagate=prev and self.flow_propagation,
                    lidar_token=lidar_token)
                if modar is None:
                    modar = np.zeros((0, 9))
                if modar.shape[0]:
                    ego_se3_lidar = ego_se3_glob @ self.source.get_pose(lidar_token)
                    # written back into modar's dtype, as the JAX package
                    modar[:, :7] = apply_se3(ego_se3_lidar, boxes=modar[:, :7])
                exchange_boxes[lidar_id] = modar
                exchange_metadata[lidar_id] = modar.shape[0]

        input_dict = {
            "points": np.zeros((1, 7)),
            "gt_boxes": np.asarray(gt_boxes, dtype=np.float64)[:, :7],
            "gt_names": np.asarray(gt_names),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"lidar_token": info["lidar_token"],
                         "num_sweeps_target": self.num_sweeps,
                         "sample_token": sample_token,
                         "lidar_id": EGO_LIDAR_ID,
                         "num_original": 0,
                         "exchange": exchange_metadata,
                         "exchange_boxes": exchange_boxes},
        }
        return self.prepare_data(input_dict, rng)
