"""SE(3) helpers on the host, in numpy float64: the port's copy of the parts
of ``pcp_tpu/utils/geometry.py`` that the exchange needs."""
import numpy as np


def se3_inverse(tf_mat):
    rot = tf_mat[:3, :3]
    t = tf_mat[:3, 3]
    out = np.eye(4)
    out[:3, :3] = rot.T
    out[:3, 3] = -rot.T @ t
    return out


def wrap_angle(a):
    """Wrap angles to (-pi, pi]."""
    return np.arctan2(np.sin(a), np.cos(a))


def apply_se3(tf_mat, points=None, boxes=None):
    """Apply a 4x4 SE(3) transform to copies of the inputs.

    points: (N, 3+): xyz columns transformed, extra feature columns untouched.
    boxes:  (N, 7+): center transformed, heading += yaw(tf), wrapped.
    Returns the transformed array, or a tuple of both when both are given.
    """
    rot = tf_mat[:3, :3]
    t = tf_mat[:3, 3]
    outs = []
    if points is not None:
        pts = points.copy()
        pts[:, :3] = pts[:, :3] @ rot.T + t
        outs.append(pts)
    if boxes is not None:
        bxs = boxes.copy()
        if bxs.shape[0] > 0:
            bxs[:, :3] = bxs[:, :3] @ rot.T + t
            yaw = np.arctan2(rot[1, 0], rot[0, 0])
            bxs[:, 6] = wrap_angle(bxs[:, 6] + yaw)
        outs.append(bxs)
    return outs[0] if len(outs) == 1 else tuple(outs)
