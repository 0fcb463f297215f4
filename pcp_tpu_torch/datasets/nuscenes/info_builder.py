"""nuScenes info building from the raw database.

Counterpart of ``pcp_tpu/datasets/nuscenes/info_builder.py`` (the reference's
``nuscenes_utils.py`` fill_trainval_infos and create_nuscenes_info). Every
table is read through the devkit's interface on a ``nusc`` object
(``.sample`` and ``.scene`` lists, ``.get(table, token)``,
``.get_sample_data_path(token)``), so the infos build from the devkit's
``NuScenes`` or on any object with that interface; without one
:func:`create_nuscenes_infos` imports the devkit and raises ImportError where
it is absent. Quaternions go through ``utils/geometry.py``.

An info holds lidar_path (relative to the data root), token, timestamp, the
past sweeps (lidar_path, sample_data_token, transform_matrix into the
keyframe's lidar frame, time_lag; the first sweep repeated where the chain
ends), ref_from_car, car_from_global, and without ``test`` gt_boxes (N, 9)
[x y z dx dy dz yaw vx vy] in the keyframe's lidar frame, gt_names mapped to
the detection classes, gt_boxes_velocity, gt_boxes_token, num_lidar_pts and
num_radar_pts; a box with no lidar and no radar point is left out. A box's
velocity is the finite difference of its neighbouring annotations' centres
(NaN without one, or beyond 1.5 s, 3 s across both).
"""
import pickle
from functools import reduce
from pathlib import Path

import numpy as np

from ...utils.geometry import quat_to_rotmat

# reference nuscenes_utils.py:11-41 (public constant mapping)
map_name_from_general_to_detection = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


def transform_matrix(translation, rotation_wxyz, inverse=False):
    """4x4 homogeneous transform from translation + quaternion (w,x,y,z)."""
    tm = np.eye(4)
    rot = quat_to_rotmat(np.asarray(rotation_wxyz, dtype=np.float64))
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.asarray(translation, dtype=np.float64)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = np.asarray(translation, dtype=np.float64)
    return tm


def quaternion_yaw(rot):
    """Yaw of a rotation matrix (projection of the x-axis onto the xy plane)."""
    v = rot @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def get_available_scenes(nusc):
    """Scenes whose reference lidar file exists on disk (ref :158-183)."""
    available = []
    for scene in nusc.scene:
        scene_token = scene["token"]
        sample = nusc.get("sample", scene["first_sample_token"])
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        lidar_path = nusc.get_sample_data_path(sd["token"])
        if Path(lidar_path).exists():
            available.append({"token": scene_token, "name": scene.get("name", scene_token)})
    return available


def _box_velocity(nusc, anno, max_time_diff=1.5):
    """Finite-difference global-frame velocity (devkit box_velocity)."""
    has_prev = anno["prev"] != ""
    has_next = anno["next"] != ""
    if not has_prev and not has_next:
        return np.full(3, np.nan)
    first = nusc.get("sample_annotation", anno["prev"]) if has_prev else anno
    last = nusc.get("sample_annotation", anno["next"]) if has_next else anno
    pos_diff = np.asarray(last["translation"], np.float64) - np.asarray(
        first["translation"], np.float64)
    t_first = 1e-6 * nusc.get("sample", first["sample_token"])["timestamp"]
    t_last = 1e-6 * nusc.get("sample", last["sample_token"])["timestamp"]
    time_diff = t_last - t_first
    if has_prev and has_next:
        max_time_diff *= 2
    if time_diff > max_time_diff or time_diff <= 0:
        return np.full(3, np.nan)
    return pos_diff / time_diff


def get_sample_data(nusc, sample_data_token):
    """(lidar_path, boxes-in-sensor-frame) — devkit nusc.get_sample_data.

    Each box dict: center (3,), size wlh (3,), rot (3,3), name, token,
    velocity (3,) in the sensor frame.
    """
    sd = nusc.get("sample_data", sample_data_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd["ego_pose_token"])
    lidar_path = nusc.get_sample_data_path(sample_data_token)

    car_from_global = transform_matrix(pose["translation"], pose["rotation"], inverse=True)
    sensor_from_car = transform_matrix(cs["translation"], cs["rotation"], inverse=True)
    sensor_from_global = sensor_from_car @ car_from_global

    sample = nusc.get("sample", sd["sample_token"])
    boxes = []
    for anno_token in sample["anns"]:
        anno = nusc.get("sample_annotation", anno_token)
        center_g = np.asarray(anno["translation"], np.float64)
        rot_g = quat_to_rotmat(np.asarray(anno["rotation"], np.float64))
        vel_g = _box_velocity(nusc, anno)
        center = sensor_from_global[:3, :3] @ center_g + sensor_from_global[:3, 3]
        rot = sensor_from_global[:3, :3] @ rot_g
        vel = sensor_from_global[:3, :3] @ np.nan_to_num(vel_g)
        boxes.append({
            "center": center,
            "wlh": np.asarray(anno["size"], np.float64),
            "rot": rot,
            "velocity": vel,
            "name": anno["category_name"],
            "token": anno_token,
            "num_lidar_pts": int(anno.get("num_lidar_pts", 1)),
            "num_radar_pts": int(anno.get("num_radar_pts", 0)),
        })
    return lidar_path, boxes


def fill_trainval_infos(data_path, nusc, train_scenes, val_scenes, test=False, max_sweeps=10):
    """Reference fill_trainval_infos (:253-381), devkit-free."""
    data_path = Path(data_path)
    train_infos, val_infos = [], []

    for sample in nusc.sample:
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd = nusc.get("sample_data", ref_sd_token)
        ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]

        ref_lidar_path, ref_boxes = get_sample_data(nusc, ref_sd_token)

        ref_from_car = transform_matrix(ref_cs["translation"], ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"], ref_pose["rotation"], inverse=True)

        info = {
            "lidar_path": str(Path(ref_lidar_path).relative_to(data_path)),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }
        if "CAM_FRONT" in sample["data"]:
            cam_sd = nusc.get("sample_data", sample["data"]["CAM_FRONT"])
            cam_cs = nusc.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
            info["cam_front_path"] = str(
                Path(nusc.get_sample_data_path(cam_sd["token"])).relative_to(data_path))
            info["cam_intrinsic"] = np.asarray(cam_cs.get("camera_intrinsic", np.eye(3)))

        # past-sweep chain with relative transforms (ref :296-345)
        curr_sd = ref_sd
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr_sd["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "sample_data_token": curr_sd["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr_sd = nusc.get("sample_data", curr_sd["prev"])
                pose = nusc.get("ego_pose", curr_sd["ego_pose_token"])
                global_from_car = transform_matrix(pose["translation"], pose["rotation"])
                cs = nusc.get("calibrated_sensor", curr_sd["calibrated_sensor_token"])
                car_from_current = transform_matrix(cs["translation"], cs["rotation"])
                tm = reduce(np.dot, [ref_from_car, car_from_global, global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": str(
                        Path(nusc.get_sample_data_path(curr_sd["token"])).relative_to(data_path)),
                    "sample_data_token": curr_sd["token"],
                    "transform_matrix": tm,
                    "global_from_car": global_from_car,
                    "car_from_current": car_from_current,
                    "time_lag": ref_time - 1e-6 * curr_sd["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            num_lidar_pts = np.array([b["num_lidar_pts"] for b in ref_boxes], np.int64)
            num_radar_pts = np.array([b["num_radar_pts"] for b in ref_boxes], np.int64)
            mask = num_lidar_pts + num_radar_pts > 0

            locs = np.array([b["center"] for b in ref_boxes]).reshape(-1, 3)
            # wlh -> dx dy dz (lwh)
            dims = np.array([b["wlh"] for b in ref_boxes]).reshape(-1, 3)[:, [1, 0, 2]]
            velocity = np.array([b["velocity"] for b in ref_boxes]).reshape(-1, 3)
            rots = np.array([quaternion_yaw(b["rot"]) for b in ref_boxes]).reshape(-1, 1)
            names = np.array([
                map_name_from_general_to_detection.get(b["name"], b["name"])
                for b in ref_boxes])
            tokens = np.array([b["token"] for b in ref_boxes])
            gt_boxes = np.concatenate([locs, dims, rots, velocity[:, :2]], axis=1)

            info["gt_boxes"] = gt_boxes[mask, :]
            info["gt_boxes_velocity"] = velocity[mask, :]
            info["gt_names"] = names[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["num_lidar_pts"] = num_lidar_pts[mask]
            info["num_radar_pts"] = num_radar_pts[mask]

        if sample["scene_token"] in train_scenes:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_infos(version, data_path, save_path, max_sweeps=10, nusc=None,
                          logger=None):
    """Build + write the train/val info pkls (reference create_nuscenes_info).

    ``nusc``: pass a devkit NuScenes or a schema-faithful mock; when None the
    devkit is imported (raises a clear error if absent).
    """
    data_path = Path(data_path)
    save_path = Path(save_path)
    if nusc is None:
        try:
            from nuscenes import NuScenes
        except ImportError as e:
            raise ImportError("info building requires nuscenes-devkit or an injected nusc") from e
        nusc = NuScenes(version=version, dataroot=str(data_path), verbose=False)

    available = {s["token"] for s in get_available_scenes(nusc)}
    train_scenes, val_scenes = set(), set()
    for scene in nusc.scene:
        if scene["token"] not in available:
            continue
        log = nusc.get("log", scene["log_token"])
        # standard split: everything not in a val log is train; mini versions
        # and mocks may carry an explicit scene['split'] hint
        if scene.get("split") == "val":
            val_scenes.add(scene["token"])
        else:
            train_scenes.add(scene["token"])

    train_infos, val_infos = fill_trainval_infos(
        data_path, nusc, train_scenes, val_scenes, test=False, max_sweeps=max_sweeps)

    save_path.mkdir(parents=True, exist_ok=True)
    p_train = save_path / f"nuscenes_infos_{max_sweeps}sweeps_train.pkl"
    p_val = save_path / f"nuscenes_infos_{max_sweeps}sweeps_val.pkl"
    with open(p_train, "wb") as f:
        pickle.dump(train_infos, f)
    with open(p_val, "wb") as f:
        pickle.dump(val_infos, f)
    if logger is not None:
        logger.info(f"nuscenes infos: train {len(train_infos)} -> {p_train}, "
                    f"val {len(val_infos)} -> {p_val}")
    return train_infos, val_infos
