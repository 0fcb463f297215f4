"""CenterNet heatmap helpers: target splatting and decode.

Counterpart of ``gaussian_radius``, ``splat_gaussians``, ``exact_topk``,
``topk_heatmap`` and ``decode_bbox_from_heatmap`` in
``pcp_tpu/models/model_utils/centernet_utils.py``. Heatmaps keep the JAX
layout (B, H, W, C). Top-k is a stable descending sort, so equal scores go to
the lower index, as in the JAX package. Outputs have fixed shapes with a
``valid`` mask instead of being filtered.
"""
import torch


def gaussian_radius(height, width, min_overlap=0.5):
    """Smallest gaussian radius that keeps IoU >= ``min_overlap`` (the
    CornerNet recipe), elementwise, in the JAX package's operation order.
    The divisor is a tensor: CUDA divides by a Python number as a multiply
    by its reciprocal, which can move a radius across an integer."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / height.new_tensor(1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4.0 * c2, min=0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat_gaussians(centers, radii, class_ids, valid, num_classes, size_xy, patch_radius=10):
    """Draw each object's gaussian into its class heatmap, combining by max.

    Args:
        centers: (B, M, 2) float (x, y) feature-map coordinates, >= 0.
        radii: (B, M) int radii, already at least the minimum radius; they
            are clipped to ``patch_radius``.
        class_ids: (B, M) int in [0, num_classes).
        valid: (B, M) bool.
        size_xy: (W, H).
    Returns:
        (B, H, W, num_classes) float32, 0 where no gaussian reaches; cells
        outside the map are dropped.
    """
    w, h = size_xy
    b, m = radii.shape
    side = 2 * patch_radius + 1
    dev = centers.device
    offs = torch.arange(side, device=dev) - patch_radius
    du, dv = offs[None, :].expand(side, side), offs[:, None].expand(side, side)

    center_int = centers.to(torch.int32)  # floor for non-negative coordinates
    r = torch.clamp(radii, max=patch_radius)[..., None, None]
    cx = center_int[..., 0, None, None] + du
    cy = center_int[..., 1, None, None] + dv
    sigma = (2 * r.to(torch.float32) + 1) / 6.0
    val = torch.exp(-(du.to(torch.float32) ** 2 + dv.to(torch.float32) ** 2) / (2 * sigma ** 2))
    ok = (valid[..., None, None] & (du.abs() <= r) & (dv.abs() <= r)
          & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))
    size = h * w * num_classes
    idx = torch.where(ok, (cy * w + cx) * num_classes + class_ids[..., None, None].to(cx.dtype), size)
    hm = torch.zeros((b, size + 1), dtype=torch.float32, device=dev)  # the last is a sentinel
    hm.scatter_reduce_(1, idx.reshape(b, -1).long(), torch.where(ok, val, 0.0).reshape(b, -1),
                       reduce="amax", include_self=True)
    return hm[:, :size].reshape(b, h, w, num_classes)


def exact_topk(x, k):
    """Top-k along the last axis; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_heatmap(scores, k):
    """Per-class then global top-k. scores: (B, H, W, C). Returns score,
    flat_ind (into H*W), class_id, y, x, each (B, k)."""
    b, h, w, c = scores.shape
    k = min(k, h * w)
    s = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cls_score, cls_ind = exact_topk(s, k)  # (B, C, k)
    ys = torch.div(cls_ind, w, rounding_mode="floor").float()
    xs = (cls_ind % w).float()
    topk_score, topk_ind = exact_topk(cls_score.reshape(b, c * k), k)
    topk_class = torch.div(topk_ind, k, rounding_mode="floor").to(torch.int32)

    def gather(t):
        return torch.gather(t.reshape(b, c * k), 1, topk_ind)

    return topk_score, gather(cls_ind), topk_class, gather(ys), gather(xs)


def decode_bbox_from_heatmap(heatmap, rot_cos, rot_sin, center, center_z, dim,
                             point_cloud_range, voxel_size, feature_map_stride, vel=None, k=500,
                             score_thresh=None, post_center_limit_range=None):
    """Top-k boxes from head outputs, all (B, H, W, ·). Returns pred_boxes
    (B, k, 7), or (B, k, 9) with ``vel`` (vx, vy appended), pred_scores
    (B, k), pred_labels (B, k), valid (B, k)."""
    b, h, w, nc = heatmap.shape
    k = min(k, h * w)
    stacked = [center, rot_sin, rot_cos, center_z, dim] + ([] if vel is None else [vel])
    widths = [f.shape[-1] for f in stacked]
    flat = torch.cat([f.reshape(b, h * w, f.shape[-1]) for f in stacked], dim=-1)

    if nc == 1:
        scores, inds = exact_topk(heatmap.reshape(b, h * w), k)
        class_ids = torch.zeros((b, k), dtype=torch.int32, device=heatmap.device)
        ys = torch.div(inds, w, rounding_mode="floor").float()
        xs = (inds % w).float()
    else:
        scores, inds, class_ids, ys, xs = topk_heatmap(heatmap, k)
    gathered = torch.gather(flat, 1, inds[..., None].expand(-1, -1, flat.shape[-1]))
    center, rot_sin, rot_cos, center_z, dim, *rest = torch.split(gathered, widths, dim=-1)

    angle = torch.atan2(rot_sin, rot_cos)
    xs = (xs[..., None] + center[..., 0:1]) * feature_map_stride * voxel_size[0] + point_cloud_range[0]
    ys = (ys[..., None] + center[..., 1:2]) * feature_map_stride * voxel_size[1] + point_cloud_range[1]
    boxes = torch.cat([xs, ys, center_z, dim, angle, *rest], dim=-1)

    valid = torch.ones((b, k), dtype=torch.bool, device=heatmap.device)
    if post_center_limit_range is not None:
        lim = torch.tensor(list(post_center_limit_range), dtype=boxes.dtype, device=boxes.device)
        valid &= (boxes[..., :3] >= lim[:3]).all(-1) & (boxes[..., :3] <= lim[3:]).all(-1)
    if score_thresh is not None:
        valid &= scores > score_thresh
    return {"pred_boxes": boxes, "pred_scores": scores, "pred_labels": class_ids, "valid": valid}
