"""Box and range masks on the host, in numpy: counterpart of the parts of
``pcp_tpu/utils/box_utils.py`` the V2X data processor uses."""
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
