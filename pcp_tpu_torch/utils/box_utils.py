"""Box math on the host, in numpy: counterpart of ``pcp_tpu/utils/box_utils.py``.

Corners, range masks, the heading period, the conversions between lidar
centre boxes and KITTI's camera boxes, image boxes, and the removal of the
points inside boxes that the gt sampler uses."""
import numpy as np


def boxes_to_corners_3d(boxes):
    """(N, 7) -> (N, 8, 3) corners: the bottom face (x+y+, x-y+, x-y-, x+y-),
    then the top face."""
    boxes = np.asarray(boxes)
    corners_norm = np.array([[1, 1, -1], [-1, 1, -1], [-1, -1, -1], [1, -1, -1],
                             [1, 1, 1], [-1, 1, 1], [-1, -1, 1], [1, -1, 1]],
                            dtype=boxes.dtype) / 2.0
    corners = boxes[:, None, 3:6] * corners_norm[None]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], axis=-1).reshape(-1, 3, 3)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + boxes[:, None, 0:3]


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """True for the boxes with at least ``min_num_corners`` corners inside
    ``limit_range``."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), dtype=bool)
    corners = boxes_to_corners_3d(boxes[:, :7])
    inside = ((corners >= np.asarray(limit_range[0:3]))
              & (corners <= np.asarray(limit_range[3:6]))).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners


def mask_points_by_range(points, limit_range):
    """True for the points whose xy lie in the range (closed)."""
    return ((points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
            & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4]))


def limit_period(val, offset=0.5, period=np.pi * 2):
    return val - np.floor(val / period + offset) * period


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """(N, 7) lidar centre boxes -> (N, 7) [x, y, z, l, h, w, ry] boxes of the
    rectified camera, origin at the bottom centre."""
    b = np.array(boxes3d_lidar, dtype=np.float64, copy=True)
    l, w, h = b[:, 3:4], b[:, 4:5], b[:, 5:6]
    b[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(b[:, 0:3].astype(np.float32))
    return np.concatenate([xyz_cam, l, h, w, -b[:, 6:7] - np.pi / 2], axis=-1)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x, y, z, l, h, w, ry] camera boxes -> (N, 7) lidar centre boxes."""
    b = np.array(boxes3d_camera, dtype=np.float64, copy=True)
    xyz_camera, r = b[:, 0:3], b[:, 6:7]
    l, h, w = b[:, 3:4], b[:, 4:5], b[:, 5:6]
    xyz_lidar = calib.rect_to_lidar(xyz_camera.astype(np.float32)).astype(np.float64)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_kitti_fakelidar_to_lidar(boxes3d_lidar):
    """Old (w, l, h, bottom z) lidar boxes -> centre boxes."""
    b = np.array(boxes3d_lidar, dtype=np.float64, copy=True)
    w, l, h = b[:, 3:4], b[:, 4:5], b[:, 5:6]
    b[:, 2] += h[:, 0] / 2
    return np.concatenate([b[:, 0:3], l, w, h, -(b[:, 6:7] + np.pi / 2)], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes -> (N, 8, 3) float32 corners."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], axis=1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], axis=1)
    if bottom_center:
        y_c = np.zeros((n, 8))
        y_c[:, 4:8] = -h[:, None]
    else:
        y_c = np.stack([h / 2] * 4 + [-h / 2] * 4, axis=1)
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(n), np.ones(n)
    rot = np.stack([np.stack([np.cos(ry), zeros, -np.sin(ry)], axis=-1),
                    np.stack([zeros, ones, zeros], axis=-1),
                    np.stack([np.sin(ry), zeros, np.cos(ry)], axis=-1)], axis=1)
    corners = np.stack([x_c, y_c, z_c], axis=2) @ rot
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes, clipped to
    ``image_shape`` (h, w) where given."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, [0, 2]] = np.clip(boxes2d[:, [0, 2]], 0, image_shape[1] - 1)
        boxes2d[:, [1, 3]] = np.clip(boxes2d[:, [1, 3]], 0, image_shape[0] - 1)
    return boxes2d


def remove_points_in_boxes(points, boxes):
    """The points inside none of ``boxes`` (z against the centre, strict
    inequalities, no margin): the gt sampler's rule."""
    keep = np.ones(points.shape[0], dtype=bool)
    for b in boxes:
        rel = points[:, :3] - b[:3]
        c, s = np.cos(b[6]), np.sin(b[6])
        lx = c * rel[:, 0] + s * rel[:, 1]
        ly = -s * rel[:, 0] + c * rel[:, 1]
        keep &= ~((np.abs(lx) < b[3] / 2) & (np.abs(ly) < b[4] / 2)
                  & (np.abs(rel[:, 2]) < b[5] / 2))
    return points[keep]
