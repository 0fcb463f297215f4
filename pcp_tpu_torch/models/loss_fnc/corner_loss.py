"""Corner-distance regularisation: counterpart of
``pcp_tpu/models/loss_fnc/corner_loss.py``.

Per box, the mean over the 8 corners of a delta-1 Huber of the distance to
the gt's corners or to those of the gt turned by pi, whichever is nearer.
"""
import math

import torch

_CORNERS = ((1, 1, -1), (-1, 1, -1), (-1, -1, -1), (1, -1, -1),
            (1, 1, 1), (-1, 1, 1), (-1, -1, 1), (1, -1, 1))


def boxes_to_corners_3d(boxes):
    """(..., 7) -> (..., 8, 3), the corner order of ``utils/box_utils.py``."""
    norm = torch.tensor(_CORNERS, dtype=boxes.dtype, device=boxes.device) / 2.0
    corners = boxes[..., None, 3:6] * norm
    c, s = torch.cos(boxes[..., 6])[..., None], torch.sin(boxes[..., 6])[..., None]
    x, y = corners[..., 0], corners[..., 1]
    rotated = torch.stack([c * x - s * y, s * x + c * y, corners[..., 2]], dim=-1)
    return rotated + boxes[..., None, 0:3]


def get_corner_loss_lidar(pred_boxes, gt_boxes):
    """pred and gt (..., 7) -> the per-box corner loss (...)."""
    pred_c = boxes_to_corners_3d(pred_boxes)
    gt_c = boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:7] + math.pi], dim=-1)
    d = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=-1),
                      torch.linalg.norm(pred_c - boxes_to_corners_3d(gt_flip), dim=-1))
    huber = torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)
    return huber.mean(dim=-1)
