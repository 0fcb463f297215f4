"""Exchange database: the V2X communication channel.

Counterpart of ``pcp_tpu/exchange/database.py``, with the same files and the
same ``data`` key, so that either package reads the database the other
wrote. A sender writes, per keyframe and lidar:

    {sample_token}_id{lidar_id}_modar.npz       -> (N, 9)  box7, score, label
    {sample_token}_id{lidar_id}_foreground.npz  -> (M, 13) point7 (x, y, z,
                                                    intensity, time, sweep,
                                                    instance), cls_prob3, flow3
    {sample_token}_id{lidar_id}_boxflow.npz     -> (N, 12) box7, score, label,
                                                    per-box pooled flow3

``boxflow`` carries what the ego needs of the foreground (the mean scene
flow of the points in each box) in 3 floats a box; readers prefer it. The
host side stays in numpy float64, as the JAX package keeps it. Points in
boxes are found by the native host kernel (``native/``), the route of the
JAX package's exchange, source and ego dataset.
"""
from pathlib import Path

import numpy as np

from ..native import points_in_boxes_np


def pool_box_flow(modar, foreground):
    """Sender-side flow pooling: (N, 9) modar + (M, 13) foreground ->
    (N, 12) float64 rows ``[box7, score, label, mean_flow3]``: the mean flow
    of the foreground points in each box (its first containing box); a box
    without member points gets zero flow."""
    modar = np.asarray(modar)
    out = np.zeros((modar.shape[0], 12), dtype=np.float64)
    out[:, :9] = modar[:, :9]
    if foreground is not None and foreground.shape[0] > 0 and modar.shape[0] > 0:
        box_idx = points_in_boxes_np(foreground[:, :3], modar[:, :7])
        valid = box_idx > -1
        if valid.any():
            fg, bi = foreground[valid], box_idx[valid]
            for b in np.unique(bi):
                out[b, 9:12] = fg[bi == b, -3:].mean(axis=0)
    return out


class ExchangeDatabase:
    """The files of one directory; ``kind`` is modar, foreground or boxflow."""

    def __init__(self, directory):
        self.directory = Path(directory)

    def _path(self, sample_token, lidar_id, kind):
        return self.directory / f"{sample_token}_id{lidar_id}_{kind}.npz"

    def save(self, sample_token, lidar_id, kind, data):
        self.directory.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(self._path(sample_token, lidar_id, kind), data=np.asarray(data))

    def load(self, sample_token, lidar_id, kind):
        """The array, or None when the sender broadcast nothing of ``kind``."""
        p = self._path(sample_token, lidar_id, kind)
        if not p.exists():
            return None
        with np.load(p) as f:
            return f["data"]

    def size_bytes(self, sample_token, lidar_id, kind):
        p = self._path(sample_token, lidar_id, kind)
        return p.stat().st_size if p.exists() else 0
