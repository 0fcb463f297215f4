"""World-level augmentations on the host, in numpy: counterpart of
``pcp_tpu/datasets/augmentor/augmentor_utils.py:11-160``, the three that the
V2X configs use (flip along x and y, rotation about z, scaling), each
drawing from the sample's ``np.random.RandomState`` in the JAX package's
order. As there, the MoDAR rows' headings (column 8 of >= 13-feature points
whose box label is > 0) turn with the world, the ``instances_tf`` correction
transforms are conjugated and the ``se3_from_ego`` agent poses in the
metadata are updated.
"""
import numpy as np


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rotate_points_along_z(points, angle):
    """points (N, 3+C): rotates the first 3 columns; angle increases x->y."""
    rot = _rot_z(angle)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot.T
    return out


def _conjugate_instances_tf(data_dict, tf):
    inv_tf = np.linalg.inv(tf)
    data_dict["instances_tf"] = np.matmul(tf[np.newaxis, np.newaxis], data_dict["instances_tf"])
    data_dict["instances_tf"] = np.matmul(data_dict["instances_tf"], inv_tf[np.newaxis, np.newaxis])


def _update_se3_from_ego(data_dict, tf):
    meta = data_dict.get("metadata", {})
    if isinstance(meta, dict) and "se3_from_ego" in meta:
        for k, tf_from_ego in meta["se3_from_ego"].items():
            # ego frame is transformed by tf; agent frames are not
            meta["se3_from_ego"][k] = np.linalg.inv(tf @ np.linalg.inv(tf_from_ego))


def _wrap_angles(a):
    return np.arctan2(np.sin(a), np.cos(a))


def _modar_mask(points):
    # >= 13-feature layout: [...| box_score(9), box_label(10), sweep(11), inst(12)]
    return points[:, -3] > 0


def random_flip_along_x(data_dict, rng, enable=None):
    """Mirror across the x axis: y -> -y."""
    if enable is None:
        enable = rng.choice([False, True], replace=False, p=[0.5, 0.5])
    if enable:
        data_dict["gt_boxes"][:, 1] *= -1
        data_dict["gt_boxes"][:, 6] *= -1
        data_dict["points"][:, 1] *= -1
        if data_dict["gt_boxes"].shape[1] > 7:
            data_dict["gt_boxes"][:, 8] *= -1  # vy
        tf = np.diag([1.0, -1.0, 1.0, 1.0])
        if "instances_tf" in data_dict:
            _conjugate_instances_tf(data_dict, tf)
        _update_se3_from_ego(data_dict, tf)
        if data_dict["points"].shape[1] >= 13:
            m = _modar_mask(data_dict["points"])
            data_dict["points"][m, 8] *= -1  # modar heading
    return enable


def random_flip_along_y(data_dict, rng, enable=None):
    """Mirror across the y axis: x -> -x."""
    if enable is None:
        enable = rng.choice([False, True], replace=False, p=[0.5, 0.5])
    if enable:
        data_dict["gt_boxes"][:, 0] *= -1
        data_dict["gt_boxes"][:, 6] = -(data_dict["gt_boxes"][:, 6] + np.pi)
        data_dict["points"][:, 0] *= -1
        if data_dict["gt_boxes"].shape[1] > 7:
            data_dict["gt_boxes"][:, 7] *= -1  # vx
        tf = np.diag([-1.0, 1.0, 1.0, 1.0])
        if "instances_tf" in data_dict:
            _conjugate_instances_tf(data_dict, tf)
        _update_se3_from_ego(data_dict, tf)
        if data_dict["points"].shape[1] >= 13:
            m = _modar_mask(data_dict["points"])
            data_dict["points"][m, 8] = _wrap_angles(-(data_dict["points"][m, 8] + np.pi))
    return enable


def global_rotation(data_dict, rot_range, rng, noise_rotation=None):
    if noise_rotation is None:
        noise_rotation = rng.uniform(rot_range[0], rot_range[1])
    data_dict["points"] = rotate_points_along_z(data_dict["points"], noise_rotation)
    gt = data_dict["gt_boxes"]
    gt[:, 0:3] = gt[:, 0:3] @ _rot_z(noise_rotation).T
    gt[:, 6] += noise_rotation
    if gt.shape[1] > 7:
        vel = np.hstack([gt[:, 7:9], np.zeros((gt.shape[0], 1))])
        gt[:, 7:9] = (vel @ _rot_z(noise_rotation).T)[:, :2]
    tf = np.eye(4)
    tf[:3, :3] = _rot_z(noise_rotation)
    if "instances_tf" in data_dict:
        _conjugate_instances_tf(data_dict, tf)
    _update_se3_from_ego(data_dict, tf)
    if data_dict["points"].shape[1] >= 13:
        m = _modar_mask(data_dict["points"])
        data_dict["points"][m, 8] = _wrap_angles(data_dict["points"][m, 8] + noise_rotation)
    return noise_rotation


def global_scaling(data_dict, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return 1.0
    noise_scale = rng.uniform(scale_range[0], scale_range[1])
    data_dict["points"][:, :3] *= noise_scale
    data_dict["gt_boxes"][:, :6] *= noise_scale
    if data_dict["gt_boxes"].shape[1] > 7:
        data_dict["gt_boxes"][:, 7:] *= noise_scale
    if "instances_tf" in data_dict:
        tf = np.diag([noise_scale] * 3 + [1.0])
        _conjugate_instances_tf(data_dict, tf)
    return noise_scale


def global_translation(data_dict, noise_translate_std, rng):
    """Shift the points, the boxes and the correction transforms by one
    normal draw per axis (x, y, z in that order)."""
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = [noise_translate_std] * 3
    noise = np.array([rng.normal(0, s, 1) for s in noise_translate_std],
                     dtype=np.float64).T.reshape(3)
    data_dict["points"][:, :3] += noise
    data_dict["gt_boxes"][:, :3] += noise
    if "instances_tf" in data_dict:
        tf = np.eye(4)
        tf[:3, 3] = noise
        _conjugate_instances_tf(data_dict, tf)
    return noise
