"""Fake nuScenes-devkit databases on disk, without JAX.

``FakeNuScenes`` has the devkit's table interface (``.sample`` and
``.scene`` lists, ``.get(table, token)``, ``.get_sample_data_path(token)``)
over plain dicts, as ``tests/test_info_builders.py``'s does; the writers put
the ``.bin`` clouds under the data root:

* :func:`make_v2x_db`: the V2X-Sim schema of ``test_info_builders.py``
  (2 scenes, towns 4 and 3, 3 keyframes, lidars id_0..id_2, a semantic
  channel to be left out, 2 moving cars), the same tables and points;
* :func:`make_nusc_db`: a plain nuScenes database of ``num_scenes`` scenes
  (the first train, the others val) of ``keyframes`` keyframes, each after
  ``sweeps - 1`` non-key sweeps, ``points`` points a sweep, moving objects
  of the ten detection classes with their neighbouring annotations (so the
  finite-difference velocities of ``create_nuscenes_infos``), and with ``maps`` a
  ``(5, H, W)`` raster a keyframe (:func:`write_maps`).

Used by the CPU tests against the JAX package and by ``chip_smoke.py`` on
the card's machine, which has neither JAX nor the devkit.
"""
from pathlib import Path

import numpy as np


class FakeNuScenes:
    def __init__(self, dataroot, tables):
        self.dataroot = str(dataroot)
        self._tables = tables
        self.sample = list(tables["sample"].values())
        self.scene = list(tables["scene"].values())

    def get(self, table, token):
        return self._tables[table][token]

    def get_sample_data_path(self, sample_data_token):
        return str(Path(self.dataroot) / self._tables["sample_data"][sample_data_token]["filename"])


def _yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _write_bin(path, points_xyz, intensity=0.5):
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.zeros((points_xyz.shape[0], 5), np.float32)
    pts[:, :3] = points_xyz
    pts[:, 3] = intensity
    pts.tofile(str(path))


def _box_points(center, rng, n=24, spread=0.6):
    return center[None, :] + rng.uniform(-spread, spread, size=(n, 3))


def _tables():
    return {k: {} for k in ("scene", "log", "sample", "sample_data", "ego_pose",
                            "calibrated_sensor", "sample_annotation")}


def make_v2x_db(root):
    """(FakeNuScenes, version) of the V2X-Sim schema under ``root``."""
    version = "v2.0-trainval"
    dataroot = Path(root) / version
    tables = _tables()
    rng = np.random.default_rng(3)
    tables["calibrated_sensor"]["cs0"] = {
        "token": "cs0", "translation": [0.0, 0.0, 1.8], "rotation": _yaw_quat(0.0)}
    for si, town in enumerate((4, 3)):
        scene_tok, log_tok = f"sc{si}", f"log{si}"
        tables["log"][log_tok] = {"token": log_tok, "location": town}
        first = None
        for kf in range(3):
            t_us = int((si * 100 + kf) * 0.2e6)
            samp_tok = f"{scene_tok}_s{kf}"
            data = {}
            # agents: the RSU id0 still; cars id1 and id2 moving
            agent_pose = {0: (np.array([0.0, 0.0, 3.0]), 0.0),
                          1: (np.array([-10.0 + 4.0 * kf, 2.0, 0.0]), 0.0),
                          2: (np.array([8.0, -6.0 + 3.0 * kf, 0.0]), np.pi / 2)}
            car_centers = [np.array([5.0 + 1.0 * kf, 3.0, -1.0]),
                           np.array([-4.0, -2.0 + 0.5 * kf, -1.0])]
            for lid in range(3):
                sd_tok = f"{samp_tok}_id{lid}"
                pose_tok = f"pose_{sd_tok}"
                pos, yaw = agent_pose[lid]
                tables["ego_pose"][pose_tok] = {"token": pose_tok, "translation": pos.tolist(),
                                                "rotation": _yaw_quat(yaw)}
                fname = f"sweeps/LIDAR_TOP_id_{lid}/{sd_tok}.bin"
                tables["sample_data"][sd_tok] = {
                    "token": sd_tok, "sample_token": samp_tok,
                    "channel": f"LIDAR_TOP_id_{lid}", "timestamp": t_us,
                    "ego_pose_token": pose_tok, "calibrated_sensor_token": "cs0",
                    "prev": f"{scene_tok}_s{kf-1}_id{lid}" if kf > 0 else "",
                    "next": f"{scene_tok}_s{kf+1}_id{lid}" if kf < 2 else "",
                    "filename": fname, "is_key_frame": True}
                data[f"LIDAR_TOP_id_{lid}"] = sd_tok
                sensor_pos = pos + np.array([0.0, 0.0, 1.8])
                c, s = np.cos(-yaw), np.sin(-yaw)
                world = np.concatenate([_box_points(cc, rng) for cc in car_centers]
                                       + [np.array([[2.0, 2.0, -2.0], [-3.0, 1.0, -2.0]])], axis=0)
                rel = world - sensor_pos[None, :]
                local = np.stack([c * rel[:, 0] - s * rel[:, 1],
                                  s * rel[:, 0] + c * rel[:, 1], rel[:, 2]], axis=1)
                _write_bin(dataroot / fname, local)
            sem_tok = f"{samp_tok}_sem"
            tables["sample_data"][sem_tok] = {
                "token": sem_tok, "sample_token": samp_tok, "channel": "LIDAR_TOP_id_1_SEM",
                "timestamp": t_us, "ego_pose_token": f"pose_{samp_tok}_id1",
                "calibrated_sensor_token": "cs0", "prev": "", "next": "", "filename": "x.bin",
                "is_key_frame": True}
            data["LIDAR_TOP_id_1_SEM"] = sem_tok
            anns = []
            for ci, cc in enumerate(car_centers):
                anno_tok = f"{samp_tok}_a{ci}"
                anns.append(anno_tok)
                tables["sample_annotation"][anno_tok] = {
                    "token": anno_tok, "sample_token": samp_tok, "instance_token": f"inst{ci}",
                    "category_name": "vehicle.car", "translation": cc.tolist(),
                    "size": [1.9, 4.5, 1.6], "rotation": _yaw_quat(0.1 * ci),
                    "prev": f"{scene_tok}_s{kf-1}_a{ci}" if kf > 0 else "",
                    "next": f"{scene_tok}_s{kf+1}_a{ci}" if kf < 2 else "",
                    "num_lidar_pts": 24, "num_radar_pts": 0}
            tables["sample"][samp_tok] = {
                "token": samp_tok, "scene_token": scene_tok, "timestamp": t_us, "data": data,
                "anns": anns, "prev": f"{scene_tok}_s{kf-1}" if kf > 0 else "",
                "next": f"{scene_tok}_s{kf+1}" if kf < 2 else ""}
            if first is None:
                first = samp_tok
        tables["scene"][scene_tok] = {"token": scene_tok, "log_token": log_tok,
                                      "first_sample_token": first, "name": scene_tok}
    return FakeNuScenes(dataroot, tables), version


# category, size (w, l, h) of the fake nuScenes objects: one a detection class
NUSC_OBJECTS = (("vehicle.car", (1.9, 4.5, 1.6)), ("vehicle.truck", (2.5, 7.0, 3.0)),
                ("vehicle.construction", (2.8, 6.5, 3.2)), ("vehicle.bus.rigid", (2.9, 11.0, 3.5)),
                ("vehicle.trailer", (2.6, 9.0, 3.8)), ("movable_object.barrier", (2.5, 0.5, 1.0)),
                ("vehicle.motorcycle", (0.8, 2.1, 1.5)), ("vehicle.bicycle", (0.6, 1.7, 1.3)),
                ("human.pedestrian.adult", (0.7, 0.7, 1.8)),
                ("movable_object.trafficcone", (0.4, 0.4, 1.0)))
SWEEP_DT_US = 50000  # the lidar's 20 Hz


def make_nusc_db(root, num_scenes=2, keyframes=3, sweeps=10, points=26000, objects=30, seed=0,
                 version="v1.0-mini"):
    """(FakeNuScenes, version) of a plain nuScenes database under ``root``:
    the ego drives along x at 8 m/s, each object moves with its own
    velocity (the barriers and cones stand), a sweep holds ``points``
    points (a fifth on the objects, the rest on the ground within 50 m)."""
    dataroot = Path(root) / version
    tables = _tables()
    rng = np.random.default_rng(seed)
    tables["calibrated_sensor"]["cs_l"] = {"token": "cs_l", "translation": [0.9, 0.0, 1.8],
                                           "rotation": _yaw_quat(0.0)}
    for si in range(num_scenes):
        scene_tok, log_tok = f"ns{si}", f"nslog{si}"
        tables["log"][log_tok] = {"token": log_tok, "location": f"loc{si}"}
        kind = rng.integers(0, len(NUSC_OBJECTS), objects)
        start = np.concatenate([rng.uniform(-40, 40, (objects, 2)), np.full((objects, 1), 0.8)], 1)
        vel = np.concatenate([rng.normal(0, 4, (objects, 2)), np.zeros((objects, 1))], 1)
        vel[np.isin(kind, (5, 9))] = 0.0
        yaw = np.arctan2(vel[:, 1], vel[:, 0] + 1e-9)
        chain = []
        samples = []
        for kf in range(keyframes):
            samp_tok = f"{scene_tok}_s{kf}"
            samples.append(samp_tok)
            for sub in range(sweeps):
                t_us = int(si * 1e8) + (kf * sweeps + sub) * SWEEP_DT_US
                key = sub == sweeps - 1
                sd_tok = f"{samp_tok}_l{sub}"
                pose_tok = f"pose_{sd_tok}"
                ego = np.array([8.0 * t_us * 1e-6 - 8.0 * si * 100, 0.0, 0.0])
                tables["ego_pose"][pose_tok] = {"token": pose_tok, "translation": ego.tolist(),
                                                "rotation": _yaw_quat(0.0)}
                fname = f"{'samples' if key else 'sweeps'}/LIDAR_TOP/{sd_tok}.bin"
                tables["sample_data"][sd_tok] = {
                    "token": sd_tok, "sample_token": samp_tok, "channel": "LIDAR_TOP",
                    "timestamp": t_us, "ego_pose_token": pose_tok,
                    "calibrated_sensor_token": "cs_l", "prev": "", "next": "",
                    "filename": fname, "is_key_frame": key}
                chain.append(sd_tok)
                sensor = ego + np.array([0.9, 0.0, 1.8])
                centres = start + vel * (t_us * 1e-6 - si * 100)
                n_obj = points // 5
                which = rng.integers(0, objects, n_obj)
                dims = np.array([NUSC_OBJECTS[k][1] for k in kind])[:, [1, 0, 2]]
                local = rng.uniform(-0.5, 0.5, (n_obj, 3)) * dims[which]
                c, s = np.cos(yaw[which]), np.sin(yaw[which])
                obj = centres[which] + np.stack([c * local[:, 0] - s * local[:, 1],
                                                 s * local[:, 0] + c * local[:, 1], local[:, 2]], 1)
                r = 50.0 * np.sqrt(rng.uniform(0.0016, 1, points - n_obj))
                a = rng.uniform(-np.pi, np.pi, points - n_obj)
                ground = np.stack([sensor[0] + r * np.cos(a), sensor[1] + r * np.sin(a),
                                   rng.normal(0.0, 0.05, points - n_obj)], 1)
                _write_bin(dataroot / fname, np.concatenate([obj, ground]) - sensor[None, :],
                           intensity=rng.uniform(0, 100, points).astype(np.float32))
            t_key = int(si * 1e8) + (kf * sweeps + sweeps - 1) * SWEEP_DT_US
            anns = []
            for oi in range(objects):
                anno_tok = f"{samp_tok}_a{oi}"
                anns.append(anno_tok)
                w, l, h = NUSC_OBJECTS[kind[oi]][1]
                tables["sample_annotation"][anno_tok] = {
                    "token": anno_tok, "sample_token": samp_tok, "instance_token": f"{scene_tok}_i{oi}",
                    "category_name": NUSC_OBJECTS[kind[oi]][0],
                    "translation": (start[oi] + vel[oi] * (t_key * 1e-6 - si * 100)).tolist(),
                    "size": [w, l, h], "rotation": _yaw_quat(yaw[oi]),
                    "prev": f"{scene_tok}_s{kf-1}_a{oi}" if kf > 0 else "",
                    "next": f"{scene_tok}_s{kf+1}_a{oi}" if kf < keyframes - 1 else "",
                    "num_lidar_pts": 10, "num_radar_pts": 0}
            tables["sample"][samp_tok] = {
                "token": samp_tok, "scene_token": scene_tok, "timestamp": t_key,
                "data": {"LIDAR_TOP": f"{samp_tok}_l{sweeps - 1}"}, "anns": anns,
                "prev": f"{scene_tok}_s{kf-1}" if kf > 0 else "",
                "next": f"{scene_tok}_s{kf+1}" if kf < keyframes - 1 else ""}
        for a, b in zip(chain[:-1], chain[1:]):
            tables["sample_data"][b]["prev"] = a
            tables["sample_data"][a]["next"] = b
        tables["scene"][scene_tok] = {"token": scene_tok, "log_token": log_tok,
                                      "first_sample_token": samples[0], "name": scene_tok,
                                      "split": "train" if si == 0 else "val"}
    return FakeNuScenes(dataroot, tables), version


def write_maps(data_root, infos, make_map_representation, point_cloud_range, seed=0):
    """Write a (5, H, W) float32 raster for each info as
    ``hd_map/map_{token}.npz`` under ``data_root`` and set the info's
    ``map_path``: ``make_map_representation`` (either package's) of a few
    polygons a layer and a few straight lanes, made from ``seed``."""
    rng = np.random.default_rng(seed)
    (Path(data_root) / "hd_map").mkdir(parents=True, exist_ok=True)
    span = point_cloud_range[3] - 2.0
    for info in infos:
        layers = {}
        for name in ("drivable_area", "ped_crossing", "walkway", "carpark_area"):
            polys = []
            for _ in range(2):
                c = rng.uniform(-span, span, 2)
                ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
                rad = rng.uniform(3, 15, 6)
                polys.append(np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1))
            layers[name] = polys
        lanes = {}
        for k in range(3):
            p0, heading = rng.uniform(-span, span, 2), rng.uniform(-np.pi, np.pi)
            t = np.arange(0.0, 40.0, 1.0)[:, None]
            xy = p0 + t * np.array([np.cos(heading), np.sin(heading)])
            lanes[f"lane{k}"] = np.concatenate([xy, np.full((len(t), 1), heading)], 1)
        raster = make_map_representation(layers, lanes, np.eye(4), point_cloud_range, 0.2)
        rel = f"hd_map/map_{info['token']}.npz"
        np.savez_compressed(Path(data_root) / rel, raster.astype(np.float32))
        info["map_path"] = rel
    return infos
