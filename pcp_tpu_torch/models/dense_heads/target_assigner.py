"""CenterPoint target assignment on the device, batched.

Counterpart of ``pcp_tpu/models/dense_heads/target_assigner.py``
(``assign_targets_single_head``, there per sample under ``vmap``; here over
the batch axis directly). Coordinates are ``(x - range) / voxel / stride`` in
float32 in that order, clipped to ``[0, W - 0.5]`` and truncated; radii come
from the CornerNet recipe, truncated and raised to ``min_radius``; a box's
regression target is ``[offset (2), z, log(dim) (3), cos, sin]``, then the
gt's extra columns (the velocity of the nuScenes configs, ``gt[..., 7:9]``)
and, where the head predicts ``iou``, the calibration target last.
"""
import torch

from ..model_utils.centernet_utils import gaussian_radius, splat_gaussians


def assign_targets_single_head(gt_boxes, head_class_map, num_classes, feat_w, feat_h, stride,
                               pc_range, voxel_size, gaussian_overlap, min_radius,
                               num_max_objs=500, patch_radius=10, iou_target=None):
    """Targets of one head for a batch.

    Args:
        gt_boxes: (B, M, 8 + E) float32 ``[x y z dx dy dz yaw (E extras) cls]``,
            M == ``num_max_objs``; cls is the 1-based global class, 0 for
            padding.
        head_class_map: (num_total_classes + 1,) int, global class -> 1-based
            class of this head, 0 where the head lacks it.
        pc_range, voxel_size: sequences of floats.
        iou_target: optional (B, M), appended as the last target column.
    Returns:
        heatmap (B, H, W, num_classes), target_boxes (B, M, 8 + E [+ 1]),
        inds (B, M) int64 ``cy * W + cx`` (0 where not valid), mask (B, M) bool.
    """
    if gt_boxes.shape[1] != num_max_objs or gt_boxes.shape[-1] < 8:
        raise ValueError(f"gt_boxes must be (B, {num_max_objs}, >=8), got {tuple(gt_boxes.shape)}")
    dev = gt_boxes.device
    # tensors, not Python numbers, on the device: CUDA divides by a Python
    # number as a multiply by its reciprocal, which can move a border box
    rng = torch.tensor([float(v) for v in pc_range[:2]], dtype=torch.float32, device=dev)
    vox = torch.tensor([float(v) for v in voxel_size[:2]], dtype=torch.float32, device=dev)
    stride_t = torch.tensor(float(stride), dtype=torch.float32, device=dev)

    cls_global = gt_boxes[..., -1].to(torch.int64)
    local_cls = head_class_map.to(dev)[cls_global.clamp(0, head_class_map.shape[0] - 1)]
    dx, dy = gt_boxes[..., 3], gt_boxes[..., 4]

    coord = (gt_boxes[..., 0:2] - rng) / vox / stride_t
    coord_x = coord[..., 0].clamp(0.0, feat_w - 0.5)
    coord_y = coord[..., 1].clamp(0.0, feat_h - 0.5)
    center = torch.stack([coord_x, coord_y], -1)
    center_int = center.to(torch.int32)

    dxs = dx / vox[0] / stride_t
    dys = dy / vox[1] / stride_t
    radius = gaussian_radius(dxs, dys, min_overlap=gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=int(min_radius))

    valid = (local_cls > 0) & (dx > 0) & (dy > 0)
    heatmap = splat_gaussians(center, radius, local_cls - 1, valid, num_classes,
                              (feat_w, feat_h), patch_radius=patch_radius)

    inds = torch.where(valid, center_int[..., 1].long() * feat_w + center_int[..., 0].long(), 0)
    offs = center - center_int.to(center.dtype)
    log_dim = torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-6))
    yaw = gt_boxes[..., 6:7]
    parts = [offs, gt_boxes[..., 2:3], log_dim, torch.cos(yaw), torch.sin(yaw),
             gt_boxes[..., 7:-1]]
    if iou_target is not None:
        parts.append(iou_target[..., None])
    target = torch.cat(parts, -1)
    target = torch.where(valid[..., None], target, 0.0)
    return heatmap, target, inds, valid
