"""The ego's side of the exchange, in numpy on the host.

Counterpart of ``V2XSimDataset_EGO._load_and_propagate_modar_pred`` and of
the MoDAR rows of ``__getitem__`` in
``pcp_tpu/datasets/v2x_sim/v2x_sim_dataset_ego.py``, as module-level
functions for the ego dataset class to call (ROADMAP A8). The ego's points
have 13 features: x, y, z, intensity, time | dx, dy, dz, heading, score,
label | sweep_idx, instance_idx.
"""
import numpy as np

from ...exchange.database import points_in_boxes_np
from ...utils.geometry import apply_se3

NUM_EGO_FEATURES = 13


def load_and_propagate_modar(db, sample_token, lidar_id, propagate=True):
    """A sender's MoDAR boxes from ``db`` (an ``ExchangeDatabase``),
    advanced by twice their mean scene flow when ``propagate``: the
    keyframe interval is twice the flow's horizon (constant velocity).

    Reads ``boxflow`` where the sender wrote it, else pools the flow of the
    ``foreground`` points in each ``modar`` box here. Returns ``(modar
    (N, 9), n_foreground)``, float64 from boxflow and the file's dtype from
    modar, where ``n_foreground`` counts the foreground rows read (0 under
    boxflow), or ``(None, 0)`` when the sender broadcast nothing for this
    keyframe."""
    boxflow = db.load(sample_token, lidar_id, "boxflow")
    if boxflow is not None:
        modar = boxflow[:, :9].copy()
        if propagate and modar.shape[0]:
            modar[:, :3] += boxflow[:, 9:12] * 2.0
        return modar, 0
    modar = db.load(sample_token, lidar_id, "modar")
    if modar is None:
        return None, 0
    modar = modar.copy()
    n_fg = 0
    if propagate:
        foregr = db.load(sample_token, lidar_id, "foreground")
        if foregr is not None and foregr.shape[0] > 0 and modar.shape[0] > 0:
            n_fg = int(foregr.shape[0])
            box_idx = points_in_boxes_np(foregr[:, :3], modar[:, :7])
            valid = box_idx > -1
            if valid.any():
                fg, bi = foregr[valid], box_idx[valid]
                for b in np.unique(bi):
                    modar[b, :3] += fg[bi == b, -3:].mean(axis=0) * 2.0
    return modar, n_fg


def modar_to_points(modar, target_se3_lidar, max_sweep_idx):
    """(N, 9) MoDAR boxes in the sender's lidar frame -> (N, 13) float64
    point rows in the ego's: the boxes moved by ``target_se3_lidar`` (4x4,
    sender lidar -> ego lidar), then the box center as xyz, time 0, the
    box's size, heading, score and label, the ego's newest sweep index and
    instance -1."""
    boxes = apply_se3(target_se3_lidar, boxes=modar[:, :7])  # in modar's dtype, as the JAX package
    rows = np.zeros((modar.shape[0], NUM_EGO_FEATURES))
    rows[:, :3] = boxes[:, :3]
    rows[:, 5:9] = boxes[:, 3:7]
    rows[:, 9:11] = modar[:, 7:9]
    rows[:, -2] = max_sweep_idx
    rows[:, -1] = -1
    return rows
