"""Pseudo-sweep simulation: counterpart of
``pcp_tpu/datasets/v2x_sim/v2x_sim_utils.py``.

* ``interpolate_boxes``: linear centres and slerped headings from the
  previous keyframe's box to the current one (the last row);
* ``get_pseudo_sweeps_of_1lidar``: each object's current points pushed back
  along its interpolated past poses (the native ``sweep_expand``) to make the
  past sweeps; background points carry the newest sweep index; per-instance
  ``instances_tf`` (N_inst, n_sweeps, 4, 4) map each past sweep's points onto
  the current pose;
* ``correction_numpy``: applies those transforms.
"""
import numpy as np

from ...native import sweep_expand
from ...utils.geometry import make_se3, se3_inverse, apply_se3, quat_slerp


def _box_to_se3(box7):
    return make_se3(box7[:3], yaw=box7[6])


def interpolate_boxes(prev_box, cur_box, num_steps):
    """(num_steps, 7): linear centers + slerp heading from prev to current
    (current is the last row). Dims are the current box's."""
    ts = np.linspace(0.0, 1.0, num_steps)
    centers = np.stack(
        [np.interp(ts, [0.0, 1.0], [prev_box[i], cur_box[i]]) for i in range(3)], axis=1
    )
    # heading slerp around z
    q0 = np.array([np.cos(prev_box[6] / 2), 0.0, 0.0, np.sin(prev_box[6] / 2)])
    q1 = np.array([np.cos(cur_box[6] / 2), 0.0, 0.0, np.sin(cur_box[6] / 2)])
    headings = []
    for t in ts:
        q = quat_slerp(q0, q1, t)
        headings.append(np.arctan2(2 * (q[0] * q[3]), 1 - 2 * q[3] ** 2))
    dims = np.tile(cur_box[3:6][None], (num_steps, 1))
    return np.concatenate([centers, dims, np.asarray(headings)[:, None]], axis=1)


def get_pseudo_sweeps_of_1lidar(
    source,
    lidar_token,
    num_historical_sweeps=10,
    classes_of_interest=("car", "pedestrian"),
    points_in_boxes_by_gpu=False,  # the config's POINTS_IN_BOXES_GPU; the host kernel serves both
    threshold_boxes_by_points=1,
):
    """Returns dict with:
        points: (N, 7) x, y, z, intensity, time-lag, sweep_idx, inst_idx
        gt_boxes: (N_inst, 7), gt_names: (N_inst,),
        instances_tf: (N_inst, n_sweeps, 4, 4)
    """
    num_sweeps = num_historical_sweeps + 1
    sweep_indices = np.arange(num_sweeps)
    timelags = 1.0 - np.linspace(0.0, 1.0, num_sweeps)

    frame = source.get_frame(
        lidar_token,
        classes_of_interest=tuple(classes_of_interest),
        threshold_boxes_by_points=threshold_boxes_by_points,
    )
    points = frame["points"]  # (N, 4)
    box_idx = frame["box_idx_of_points"]
    gt_boxes = frame["boxes"]
    gt_names = frame["names"]
    prev_boxes = frame["prev_boxes"]

    # background: most recent sweep only
    backgr = points[box_idx < 0]
    backgr = np.pad(backgr, [(0, 0), (0, 3)], constant_values=0.0)
    backgr[:, 4] = timelags[-1]
    backgr[:, -2] = float(sweep_indices[-1])
    backgr[:, -1] = -1.0

    sim_points, instances_tf = [], []
    for inst_idx in range(gt_boxes.shape[0]):
        pts_of_box = points[box_idx == inst_idx].copy()  # (n, 4) in lidar

        lidar_se3_box = _box_to_se3(gt_boxes[inst_idx])
        pts_of_box = apply_se3(se3_inverse(lidar_se3_box), points=pts_of_box)  # box frame

        histo = interpolate_boxes(prev_boxes[inst_idx], gt_boxes[inst_idx], num_sweeps)  # (S,7)
        cos, sin = np.cos(histo[:, 6]), np.sin(histo[:, 6])
        zs, os_ = np.zeros(num_sweeps), np.ones(num_sweeps)
        lidar_se3_histo = np.stack(
            [
                cos, -sin, zs, histo[:, 0],
                sin, cos, zs, histo[:, 1],
                zs, zs, os_, histo[:, 2],
                zs, zs, zs, os_,
            ],
            axis=1,
        ).reshape(-1, 4, 4)

        expanded = sweep_expand(pts_of_box[:, :4], lidar_se3_histo, timelags, inst_idx)

        inst_tf = np.einsum("ij,sjk->sik", lidar_se3_histo[-1], np.linalg.inv(lidar_se3_histo))
        sim_points.append(expanded)
        instances_tf.append(inst_tf[None])

    if sim_points:
        all_points = np.concatenate([backgr] + sim_points)
        instances_tf = np.concatenate(instances_tf, axis=0)
    else:
        all_points = backgr
        instances_tf = np.zeros((0, num_sweeps, 4, 4))

    return {
        "points": all_points.astype(np.float32),
        "gt_boxes": gt_boxes.astype(np.float32),
        "gt_names": gt_names,
        "instances_tf": instances_tf.astype(np.float32),
    }


def correction_numpy(points, instances_tf):
    """Apply per-(instance, sweep) correction transforms to point xyz
    (reference correction_numpy, v2x_sim_utils.py:320-336)."""
    n_sweeps = instances_tf.shape[1]
    merge_idx = points[:, -1].astype(int) * n_sweeps + points[:, -2].astype(int)
    tf = instances_tf.reshape(-1, instances_tf.shape[-2], 4)[merge_idx]
    new_xyz = np.matmul(tf[:, :3, :3], points[:, :3, None]) + tf[:, :3, [-1]]
    return new_xyz.squeeze(axis=-1)
