"""The plain nuScenes dataset, the pretraining lineage of the HunterJr
("pointpillar_jr") configs.

Counterpart of ``pcp_tpu/datasets/nuscenes/nuscenes_dataset.py``: driven by
the info pickles of ``info_builder.py`` (at run time it needs the pickles and
the ``.bin`` files, no devkit), the keyframe's cloud and up to
``MAX_SWEEPS - 1`` past sweeps with their time lags, class-balanced
resampling of the training infos, with ``USE_HD_MAP`` the five map
features read at each point from the info's ``map_path`` raster, and the
nuScenes-protocol evaluation (``datasets/eval/detection_metrics.py``).

The JAX package's rules, kept:

* an item's points are (x, y, z, intensity, time lag), then with the map
  its five map features: a sweep is moved by its ``sensor2lidar`` entry,
  which ``info_builder.py`` does not write (it writes ``transform_matrix``),
  so sweeps keep their own frame, and no ``sweep_idx`` or ``instance_idx``
  column is made, whatever the config's feature list names (ROADMAP C);
* gt boxes are the first 7 columns of the info's (the velocity dropped);
* an info without ``map_path`` takes the map from ``MapMaker``, which needs
  the devkit (ImportError where it is absent).

The balanced resampling draws from the ``np.random.RandomState`` it is
given (the dataset's ``rng``), where the JAX package draws from numpy's
global generator: seeded alike, both draw the same infos.
"""
import copy
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate
from ..eval.detection_metrics import nuscenes_protocol_eval
from .map_utils import interpolate_map_at_points


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        root_path = (Path(root_path) if root_path is not None
                     else Path(dataset_cfg["DATA_PATH"])) / dataset_cfg["VERSION"]
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos, self.rng)

    def include_nuscenes_data(self, mode):
        for info_path in self.dataset_cfg["INFO_PATH"][mode]:
            p = self.root_path / info_path
            if not p.exists():
                if self.logger is not None:
                    self.logger.warning(f"nuScenes info missing: {p}")
                continue
            with open(p, "rb") as f:
                self.infos.extend(pickle.load(f))
        if self.logger is not None:
            self.logger.info(f"Total samples for NuScenes dataset: {len(self.infos)}")

    def balanced_infos_resampling(self, infos, rng):
        """Draw each class's infos (those naming it) with replacement, in
        proportion to bring every class to an equal share."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info.get("gt_names", [])):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        ratios = [frac / max(len(v) / duplicated, 1e-9) for v in cls_infos.values()]
        for cur_infos, ratio in zip(cls_infos.values(), ratios):
            sampled += rng.choice(cur_infos, int(len(cur_infos) * ratio)).tolist()
        return sampled or infos

    def get_sweep_points(self, info):
        """(N, 5) float32: the keyframe's points with time lag 0, then each
        past sweep's with its lag."""
        points = np.fromfile(str(self.root_path / info["lidar_path"]), dtype=np.float32)
        points = points.reshape(-1, 5)[:, :4]
        points = np.hstack([points, np.zeros((points.shape[0], 1), np.float32)])
        max_sweeps = int(self.dataset_cfg.get("MAX_SWEEPS", 1))
        all_points = [points]
        for sweep in info.get("sweeps", [])[: max_sweeps - 1]:
            sp = np.fromfile(str(self.root_path / sweep["lidar_path"]), dtype=np.float32)
            sp = sp.reshape(-1, 5)[:, :4]
            tf = sweep["sensor2lidar"] if "sensor2lidar" in sweep else np.eye(4)
            xyz = sp[:, :3] @ np.asarray(tf)[:3, :3].T + np.asarray(tf)[:3, 3]
            lag = np.full((sp.shape[0], 1), sweep.get("time_lag", 0.0), np.float32)
            all_points.append(np.hstack([xyz, sp[:, 3:4], lag]).astype(np.float32))
        return np.concatenate(all_points)

    def __len__(self):
        return len(self.infos)

    def get_hd_map(self, info):
        """(5, H, W) float32 raster: the first array of the info's
        ``map_path`` .npz, else ``MapMaker`` through the devkit."""
        if "map_path" in info:
            with np.load(self.root_path / info["map_path"]) as z:
                return z[z.files[0]].astype(np.float32)
        if not hasattr(self, "_map_maker"):
            from nuscenes import NuScenes  # the devkit, as the JAX package needs it here

            from .map_utils import MapMaker

            nusc = NuScenes(version=self.dataset_cfg["VERSION"], dataroot=str(self.root_path),
                            verbose=False)
            self._map_maker = MapMaker(
                nusc, resolution=float(self.dataset_cfg.get("MAP_RESOLUTION", 0.2)),
                point_cloud_range=tuple(self.point_cloud_range))
        return self._map_maker.make_representation(info["lidar_token"]).astype(np.float32)

    def get_item(self, index, rng):
        info = copy.deepcopy(self.infos[index])
        points = self.get_sweep_points(info)
        if bool(self.dataset_cfg.get("USE_HD_MAP", False)):
            map_feats = interpolate_map_at_points(
                self.get_hd_map(info), points, self.point_cloud_range,
                float(self.dataset_cfg.get("MAP_RESOLUTION", 0.2)))
            points = np.hstack([points[:, :5], map_feats, points[:, 5:]]).astype(np.float32)

        input_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token"),
                         "lidar_token": info.get("lidar_token", info.get("token"))},
        }
        if "gt_boxes" in info:
            input_dict["gt_boxes"] = np.asarray(info["gt_boxes"])[:, :7]
            input_dict["gt_names"] = np.asarray(info["gt_names"])
        return self.prepare_data(input_dict, rng)

    def generate_prediction_dicts(self, batch_dict, final_box_dicts, class_names):
        from ..v2x_sim.v2x_sim_dataset_rsu import V2XSimDataset_RSU

        return V2XSimDataset_RSU.generate_prediction_dicts(self, batch_dict, final_box_dicts,
                                                           class_names)

    def evaluation(self, det_annos, class_names, **kwargs):
        gt_by_token = {}
        for info in self.infos:
            gt_by_token[info.get("lidar_token", info.get("token"))] = {
                "boxes": np.asarray(info.get("gt_boxes", np.zeros((0, 7))))[:, :7],
                "names": np.asarray(info.get("gt_names", [])),
                "velocities": None,
            }
        return nuscenes_protocol_eval(det_annos, gt_by_token, class_names,
                                      output_path=kwargs.get("output_path"))

