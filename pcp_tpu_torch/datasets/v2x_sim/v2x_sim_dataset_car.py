"""V2X-Sim per-vehicle (CAV, lidar ids 1..5) dataset.

Counterpart of ``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_car.py``: the
infos of each lidar merged into one list, in training thinned by
``DATASET_DOWNSAMPLING_RATIO`` relative to the ego lidar's count. On the
real database the info pickles hold a dict of lists keyed by lidar id
(:meth:`V2XSimDataset_CAR.build_v2x_sim_info`).
"""
import pickle

from .v2x_sim_dataset_rsu import V2XSimDataset_RSU


class V2XSimDataset_CAR(V2XSimDataset_RSU):
    LIDAR_IDS = (1, 2, 3, 4, 5)

    def include_v2x_sim_data(self, mode):
        per_lidar = {lid: [] for lid in self.LIDAR_IDS}
        if self.synthetic:
            for info in self._build_infos_synthetic(self.dataset_cfg["DATA_SPLIT"][mode]):
                per_lidar[info["lidar_id"]].append(info)
        else:
            for info_path in self.dataset_cfg["INFO_PATH"][mode]:
                p = self.root_path / f"{self._prefix}_{info_path}"
                if not p.exists():
                    continue
                with open(p, "rb") as f:
                    infos = pickle.load(f)
                for lid, lst in infos.items():
                    if lid in per_lidar:
                        per_lidar[lid].extend(lst)

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
        if not self.synthetic:
            self.infos = self._filter_sem(self.infos)
        if self.logger is not None:
            self.logger.info("Total samples for V2X-Sim dataset: %d" % len(self.infos))

    def build_v2x_sim_info(self):
        """Write ``{prefix}_v2x_sim_car_infos_{N}sweeps_{train,val}.pkl``, each
        a dict of info lists keyed by lidar id 1..5 (``LIDAR_TOP_id_{i}``,
        semantic channels left out); returns (train, val) dicts."""
        assert not self.synthetic, "info building needs a (possibly mocked) V2X-Sim DB"
        trainval = self._load_trainval_split()
        nusc = self.source.nusc
        train_infos = {lid: [] for lid in range(1, 6)}
        val_infos = {lid: [] for lid in range(1, 6)}
        for sample in nusc.sample:
            for sensor_name, sensor_token in sample["data"].items():
                if "LIDAR_TOP_id_" not in sensor_name or "SEM" in sensor_name:
                    continue
                lidar_id = int(sensor_name.strip().split("_")[-1])
                if lidar_id == 0:
                    continue
                info = self._info_of_lidar_token(
                    sample, sensor_token, self.dataset_cfg.get("THRESHOLD_BOXES_BY_POINTS", 1))
                split = train_infos if sample["scene_token"] in trainval["train"] else val_infos
                split[lidar_id].append(info)
        for split, infos in (("train", train_infos), ("val", val_infos)):
            p = self.root_path / (
                f"{self._prefix}_v2x_sim_car_infos_{self.num_historical_sweeps}sweeps_{split}.pkl")
            with open(p, "wb") as f:
                pickle.dump(infos, f)
            if self.logger is not None:
                for lid, lst in infos.items():
                    self.logger.info(f"v2x-sim car infos {split} LIDAR_TOP_id_{lid}: {len(lst)}")
        return train_infos, val_infos
