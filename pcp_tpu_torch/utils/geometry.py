"""SE(3) geometry on the host, in numpy float64.

The port's copy of ``pcp_tpu/utils/geometry.py``: quaternion and rotation
matrix helpers, 4x4 pose assembly and inversion, batched transforms of
points, boxes and vectors with the heading re-wrapped, and pose
interpolation (lerp of the translation, slerp of the rotation).
"""
import numpy as np


def quat_to_rotmat(q):
    """Unit quaternion (w, x, y, z) -> (3, 3) rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def rotmat_to_quat(m):
    """(3, 3) rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quat_slerp(q0, q1, t):
    """Spherical linear interpolation between unit quaternions."""
    q0 = np.asarray(q0, dtype=np.float64)
    q1 = np.asarray(q1, dtype=np.float64)
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(d, -1.0, 1.0))
    theta = theta0 * t
    s0 = np.cos(theta) - d * np.sin(theta) / np.sin(theta0)
    s1 = np.sin(theta) / np.sin(theta0)
    return s0 * q0 + s1 * q1


def rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def make_se3(translation, *, yaw=None, quat=None, rotmat=None):
    """Assemble a 4x4 homogeneous transform from translation + one rotation rep."""
    out = np.eye(4)
    if rotmat is not None:
        out[:3, :3] = rotmat
    elif quat is not None:
        out[:3, :3] = quat_to_rotmat(quat)
    elif yaw is not None:
        out[:3, :3] = rot_z(yaw)
    out[:3, 3] = np.asarray(translation, dtype=np.float64)
    return out


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


def apply_se3(tf_mat, points=None, boxes=None, vectors=None, in_place=False):
    """Apply a 4x4 SE(3) transform.

    points: (N, 3+) — xyz columns transformed, extra feature columns untouched.
    boxes:  (N, 7+) — center transformed, heading += yaw(tf) and re-wrapped.
    vectors:(N, 3)  — rotation only.
    Returns the transformed array(s) (also mutates inputs when in_place).
    """
    rot = tf_mat[:3, :3]
    t = tf_mat[:3, 3]
    outs = []
    if points is not None:
        pts = points if in_place else points.copy()
        pts[:, :3] = pts[:, :3] @ rot.T + t
        outs.append(pts)
    if boxes is not None:
        bxs = boxes if in_place else boxes.copy()
        if bxs.shape[0] > 0:
            bxs[:, :3] = bxs[:, :3] @ rot.T + t
            yaw = np.arctan2(rot[1, 0], rot[0, 0])
            bxs[:, 6] = wrap_angle(bxs[:, 6] + yaw)
        outs.append(bxs)
    if vectors is not None:
        vec = vectors if in_place else vectors.copy()
        vec[:, :3] = vec[:, :3] @ rot.T
        outs.append(vec)
    if len(outs) == 1:
        return outs[0]
    return tuple(outs)


def interpolate_se3(tf0, tf1, t):
    """Interpolate between two poses: lerp translation, slerp rotation.
    Used for historical sweep pose simulation (reference
    v2x_sim_utils.py:156-208 interp/slerp of annotation poses)."""
    q0 = rotmat_to_quat(tf0[:3, :3])
    q1 = rotmat_to_quat(tf1[:3, :3])
    q = quat_slerp(q0, q1, t)
    trans = (1 - t) * tf0[:3, 3] + t * tf1[:3, 3]
    return make_se3(trans, quat=q)
