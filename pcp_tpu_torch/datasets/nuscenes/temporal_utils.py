"""Instance-centric sweep assembly of the HunterJr pretraining samples.

Counterpart of ``pcp_tpu/datasets/nuscenes/temporal_utils.py`` (after the
reference's ``rev_get_sweeps_instance_centric.py``): N sweeps already in the
target lidar frame are concatenated, every annotated instance is tracked
across them, and each gets its correction transforms
``instances_tf[i, s] = pose_last @ inv(pose_s)``; each point is tagged with
the instance whose box of any sweep first holds it (-1 for none), and each
instance's latest box (with velocity columns) is its gt. No model of either
package calls it. The containment test is ``ops/points_in_boxes.py`` on CPU
tensors, float32 as the JAX package's. ``revised_instance_centric_get_sweeps``
reads the database through the devkit and raises ImportError where it is
absent.
"""
import numpy as np
import torch

from ...ops.points_in_boxes import points_in_boxes
from ...utils.geometry import apply_se3, quat_to_rotmat


def build_instance_centric_sample(sweep_points, sweep_instance_boxes, n_sweeps,
                                  instance_sizes=None, instance_names=None,
                                  instance_velocities=None):
    """The geometric core.

    Args:
        sweep_points: per sweep an (N_s, >=6) array (x, y, z, intensity,
            time_lag, sweep_idx) in the target frame.
        sweep_instance_boxes: per sweep {instance_key: box7 (x y z dx dy dz
            yaw)} in the target frame.
        n_sweeps: the sweep axis of ``instances_tf``.
        instance_sizes / instance_names / instance_velocities: optional
            {instance_key: value}; sizes default to each instance's first
            box's, names to "car", velocities to zeros.

    Returns:
        {points (N, 7: ... instance_idx), instances_tf (N_inst, n_sweeps, 4,
        4), gt_boxes (N_inst, 9), gt_names}.
    """
    points = (np.concatenate([p for p in sweep_points if len(p)], axis=0)
              if any(len(p) for p in sweep_points) else np.zeros((0, 6)))

    inst_order = []
    inst_poses = {}
    for boxes in sweep_instance_boxes:
        for key, box in boxes.items():
            if key not in inst_poses:
                inst_poses[key] = []
                inst_order.append(key)
            c, s = np.cos(box[6]), np.sin(box[6])
            pose = np.eye(4)
            pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pose[:3, 3] = box[:3]
            inst_poses[key].append((pose, np.asarray(box[3:6], np.float64)))

    num_inst = len(inst_order)
    if num_inst == 0:
        pts = np.concatenate([points, -np.ones((points.shape[0], 1))], axis=1)
        return {"points": pts, "instances_tf": np.zeros((0, n_sweeps, 4, 4)),
                "gt_boxes": np.zeros((0, 9)), "gt_names": np.array([])}

    instances_tf = np.zeros((num_inst, n_sweeps, 4, 4))
    all_boxes, all_inst_idx = [], []
    last_boxes = np.zeros((num_inst, 9))
    names = []
    for i, key in enumerate(inst_order):
        entries = inst_poses[key]
        poses = np.stack([p for p, _ in entries], axis=0)
        size = (np.asarray(instance_sizes[key])
                if instance_sizes and key in instance_sizes else entries[0][1])
        instances_tf[i, : poses.shape[0]] = np.einsum("ij,bjk->bik", poses[-1], np.linalg.inv(poses))
        yaw = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
        boxes7 = np.concatenate([poses[:, :3, 3], np.tile(size, (poses.shape[0], 1)), yaw[:, None]],
                                axis=1)
        all_boxes.append(boxes7)
        all_inst_idx.extend([i] * poses.shape[0])
        vel = (np.asarray(instance_velocities[key])[:2]
               if instance_velocities and key in instance_velocities else np.zeros(2))
        last_boxes[i] = np.concatenate([boxes7[-1], vel])
        names.append(instance_names[key] if instance_names and key in instance_names else "car")

    all_boxes = np.concatenate(all_boxes, axis=0)
    all_inst_idx = np.asarray(all_inst_idx, np.int64)
    if points.shape[0]:
        box_ids = points_in_boxes(torch.from_numpy(points[:, :3].astype(np.float32)),
                                  torch.from_numpy(all_boxes.astype(np.float32))).numpy()
        pts_inst = np.where(box_ids >= 0, all_inst_idx[np.clip(box_ids, 0, None)], -1)
    else:
        pts_inst = np.zeros((0,), np.int64)
    pts = np.concatenate([points, pts_inst[:, None].astype(np.float64)], axis=1)
    return {"points": pts, "instances_tf": instances_tf,
            "gt_boxes": last_boxes, "gt_names": np.asarray(names)}


def remove_ego_vehicle_points(points, center_radius=2.0):
    """The points farther than ``center_radius`` from the sensor in xy."""
    keep = np.linalg.norm(points[:, :2], axis=1) > center_radius
    return points[keep]


def revised_instance_centric_get_sweeps(nusc, sample_token, n_sweeps,
                                        detection_classes=("car", "pedestrian", "bicycle"),
                                        center_radius=2.0, **kwargs):
    """A sample's sweeps and boxes read through the devkit, then
    :func:`build_instance_centric_sample`. Raises ImportError without the
    devkit."""
    try:
        from nuscenes.utils.geometry_utils import transform_matrix  # noqa: F401
    except ImportError as e:
        raise ImportError("revised_instance_centric_get_sweeps needs nuscenes-devkit; the "
                          "geometric core (build_instance_centric_sample) works without it") from e

    def sensor_pose(sd_token):
        sd = nusc.get("sample_data", sd_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ego = nusc.get("ego_pose", sd["ego_pose_token"])

        def tf(rec):
            m = np.eye(4)
            m[:3, :3] = quat_to_rotmat(rec["rotation"])
            m[:3, 3] = rec["translation"]
            return m
        return tf(ego) @ tf(cs)

    sample_rec = nusc.get("sample", sample_token)
    target_sd = sample_rec["data"]["LIDAR_TOP"]
    target_from_glob = np.linalg.inv(sensor_pose(target_sd))
    target_time = nusc.get("sample_data", target_sd)["timestamp"]

    sd_tokens = []
    sd = target_sd
    for _ in range(n_sweeps):
        sd_tokens.append(sd)
        prev = nusc.get("sample_data", sd)["prev"]
        if prev == "":
            break
        sd = prev
    sd_tokens = sd_tokens[::-1]  # oldest first, the target last

    sweep_points, sweep_boxes = [], []
    sizes, names, velos = {}, {}, {}
    for s_idx, sd_token in enumerate(sd_tokens):
        rec = nusc.get("sample_data", sd_token)
        pts = np.fromfile(str(nusc.get_sample_data_path(sd_token)),
                          dtype=np.float32).reshape(-1, 5)[:, :4]
        time_lag = (target_time - rec["timestamp"]) * 1e-6
        pts = np.concatenate([pts, np.full((pts.shape[0], 1), time_lag),
                              np.full((pts.shape[0], 1), s_idx)], axis=1)
        pts = remove_ego_vehicle_points(pts, center_radius)
        pts[:, :3] = apply_se3(target_from_glob @ sensor_pose(sd_token), points=pts[:, :3])
        sweep_points.append(pts)

        boxes = {}
        for box in nusc.get_boxes(sd_token):
            anno = nusc.get("sample_annotation", box.token)
            if anno["num_lidar_pts"] < 1:
                continue
            key = anno["instance_token"]
            glob_from_box = np.eye(4)
            glob_from_box[:3, :3] = box.orientation.rotation_matrix
            glob_from_box[:3, 3] = box.center
            t = target_from_glob @ glob_from_box
            yaw = np.arctan2(t[1, 0], t[0, 0])
            boxes[key] = np.array([*t[:3, 3], box.wlh[1], box.wlh[0], box.wlh[2], yaw])
            sizes.setdefault(key, [box.wlh[1], box.wlh[0], box.wlh[2]])
            names.setdefault(key, box.name)
            v = nusc.box_velocity(anno["token"])
            velos[key] = (target_from_glob[:3, :3] @ v)[:3]
        sweep_boxes.append(boxes)

    out = build_instance_centric_sample(sweep_points, sweep_boxes, n_sweeps, instance_sizes=sizes,
                                        instance_names=names, instance_velocities=velos)
    out["target_from_glob"] = target_from_glob
    return out
