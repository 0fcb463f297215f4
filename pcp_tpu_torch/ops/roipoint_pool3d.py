"""ROI point pooling: counterpart of ``pcp_tpu/ops/roipoint_pool3d.py``.

For every ROI, enlarged by ``pool_extra_width``, the first
``num_sampled_points`` contained points in index order; an ROI with fewer
repeats the ones it found, an ROI with none is flagged empty and pooled as
zeros. One (B, M, N) containment test (``ops/points_in_boxes.py``) and a
cumsum first-k selection, plain torch ops: the JAX package reaches no
Pallas kernel here.
"""
import torch

from .points_in_boxes import points_in_boxes_mask


def enlarge_boxes(rois, extra_width):
    """rois (..., 7+) grown by ``extra_width`` on each of dx, dy, dz."""
    ew = torch.as_tensor(extra_width, dtype=rois.dtype, device=rois.device)
    return torch.cat([rois[..., :3], rois[..., 3:6] + ew, rois[..., 6:]], dim=-1)


def roipoint_pool3d(points, point_features, rois, num_sampled_points=512,
                    pool_extra_width=(0.0, 0.0, 0.0), points_mask=None):
    """points (B, N, 3), point_features (B, N, C), rois (B, M, 7+) ->
    pooled (B, M, S, 3 + C) (xyz then features, global frame) and empty
    (B, M) bool."""
    b, n, _ = points.shape
    s = num_sampled_points
    inside = points_in_boxes_mask(points, enlarge_boxes(rois[..., :7], pool_extra_width))
    inside = inside.transpose(1, 2)  # (B, M, N)
    if points_mask is not None:
        inside = inside & points_mask[:, None, :]
    rank = torch.cumsum(inside, dim=-1) - 1
    pos = torch.where(inside & (rank < s), rank, s)
    out = torch.zeros((*inside.shape[:2], s + 1), dtype=torch.int64, device=points.device)
    out.scatter_(-1, pos, torch.arange(n, device=points.device).expand_as(pos))
    cnt = torch.clamp(inside.sum(dim=-1), max=s)
    slot = torch.arange(s, device=points.device) % torch.clamp(cnt, min=1)[..., None]
    idx = torch.gather(out[..., :s], -1, slot)
    empty = cnt == 0
    src = torch.cat([points, point_features], dim=-1)
    m = idx.shape[1]
    flat = torch.gather(src, 1, idx.reshape(b, m * s, 1).expand(-1, -1, src.shape[-1]))
    flat = flat.reshape(b, m, s, src.shape[-1])
    return torch.where(empty[..., None, None], 0.0, flat), empty
