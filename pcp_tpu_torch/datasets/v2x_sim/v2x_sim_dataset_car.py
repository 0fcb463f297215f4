"""V2X-Sim per-vehicle (CAV, lidar ids 1..5) dataset.

Counterpart of ``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_car.py``: the
infos of each lidar merged into one list, in training thinned by
``DATASET_DOWNSAMPLING_RATIO`` relative to the ego lidar's count.
"""
from .v2x_sim_dataset_rsu import V2XSimDataset_RSU


class V2XSimDataset_CAR(V2XSimDataset_RSU):
    LIDAR_IDS = (1, 2, 3, 4, 5)

    def include_v2x_sim_data(self, mode):
        self._require_synthetic()
        per_lidar = {lid: [] for lid in self.LIDAR_IDS}
        for info in self._build_infos_synthetic(self.dataset_cfg["DATA_SPLIT"][mode]):
            per_lidar[info["lidar_id"]].append(info)

        ratio = float(self.dataset_cfg.get("DATASET_DOWNSAMPLING_RATIO", 1))
        if self.training and ratio > 1:
            num_ego = max(float(len(per_lidar[1])), 1.0)
            for lid, lst in per_lidar.items():
                if lst:
                    lst.sort(key=lambda e: e["timestamp"])
                    stride = int((len(lst) / num_ego) * ratio)
                    if stride > 1:
                        per_lidar[lid] = lst[::stride]

        self.infos = [info for lid in self.LIDAR_IDS for info in per_lidar[lid]]
        if self.logger is not None:
            self.logger.info("Total samples for V2X-Sim dataset: %d" % len(self.infos))
