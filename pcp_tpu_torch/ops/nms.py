"""Fixed-shape greedy NMS for rotated BEV boxes.

Counterpart of ``nms_bev`` / ``class_agnostic_nms`` in ``pcp_tpu/ops/nms.py``
with the same sequential-greedy semantics: in score order (a stable sort, so
equal scores keep input order), a box is kept iff no higher-scoring kept box
overlaps it above the threshold. The recurrence is solved by fixed-point
sweeps over the (K, K) IoU matrix; after t sweeps every box whose suppression
chain is shorter than t holds its final value, and the unique fixed point is
the greedy answer. Each sweep asks the host whether anything changed, one
device-to-host sync per sweep (a handful per call); a kernel that keeps the
loop on the device is later work. Above ``PAIRS_ABOVE`` candidates the
overlaps are computed only for the pairs whose BEV circles meet, with the
dense matrix's per-pair arithmetic. Every function takes an optional
leading batch axis, and the batch is swept together.
"""
import torch

from .rotated_iou import boxes_iou_bev

# The crossover, measured on an H100 (``tools_torch/nms_fps_probe.py``): the
# CenterPoint heads' 500 candidates take the dense matrix in 14-16 ms and
# the pairs in 15-20 ms; at 1000 the two lie within 2 ms; from 2048 up the
# pairs take 11-24 ms where the dense matrix takes 70-625 ms and 2.7-26 GiB
PAIRS_ABOVE = 1000
# the pair IoU's temporaries hold about 100 bytes a pair: this many at a time
PAIR_CHUNK = 1 << 23


def _over_dense(boxes, thresh):
    idx = torch.arange(boxes.shape[-2], device=boxes.device)
    return (boxes_iou_bev(boxes, boxes) > thresh) & (idx[None, :] < idx[:, None])


def _over_pairs(boxes, thresh):
    """``_over_dense`` with the IoU taken only for the pairs (j before i)
    whose circumscribed BEV circles meet: two boxes whose circles are
    apart do not overlap, and ``thresh`` is above 0. Each pair's IoU is the
    same elementwise arithmetic as in the dense matrix."""
    if thresh <= 0:
        raise ValueError(f"NMS_THRESH {thresh} must be above 0 where pairs are skipped")
    k = boxes.shape[-2]
    flat = boxes.reshape(-1, k, boxes.shape[-1])
    r = 0.5 * torch.sqrt(flat[..., 3] ** 2 + flat[..., 4] ** 2)
    d2 = ((flat[..., :, None, 0] - flat[..., None, :, 0]) ** 2
          + (flat[..., :, None, 1] - flat[..., None, :, 1]) ** 2)
    reach = (r[..., :, None] + r[..., None, :]) * 1.001 + 1e-3
    idx = torch.arange(k, device=boxes.device)
    b, i, j = torch.nonzero((d2 <= reach * reach) & (idx[None, :] < idx[:, None]), as_tuple=True)
    over = torch.zeros(flat.shape[:2] + (k,), dtype=torch.bool, device=boxes.device)
    for s in range(0, b.numel(), PAIR_CHUNK):
        bb, ii, jj = b[s:s + PAIR_CHUNK], i[s:s + PAIR_CHUNK], j[s:s + PAIR_CHUNK]
        iou = boxes_iou_bev(flat[bb, ii][:, None, :], flat[bb, jj][:, None, :])[:, 0, 0]
        over[bb, ii, jj] = iou > thresh
    return over.reshape(*boxes.shape[:-2], k, k)


def _greedy_suppress(boxes, valid, thresh):
    """boxes: (..., K, 7); valid: (..., K) bool, in score order. Keep mask (..., K)."""
    over_fn = _over_pairs if boxes.shape[-2] > PAIRS_ABOVE else _over_dense
    # over[i, j]: valid j, earlier than i in score order, overlaps i above thresh
    over = over_fn(boxes, thresh) & valid[..., None, :]
    keep = valid
    while True:
        new_keep = valid & ~(over & keep[..., None, :]).any(-1)
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def nms_bev(boxes, scores, valid_mask, thresh, post_max_size=83):
    """Greedy rotated-BEV NMS over a fixed-capacity box buffer.

    Args:
        boxes: (..., K, 7); scores: (..., K); valid_mask: (..., K) bool.
    Returns:
        keep_idx: (..., post_max_size) int32 indices into the input order,
            -1 for padding; keep_count: (...) int32.
    """
    sort_scores = torch.where(valid_mask, scores, float("-inf"))
    order = torch.argsort(-sort_scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(*order.shape, boxes.shape[-1]))
    valid_s = torch.gather(valid_mask, -1, order)
    with torch.no_grad():  # the decisions carry no gradient: keep no graph of the IoU
        keep = _greedy_suppress(boxes_s, valid_s, thresh)

    # compact kept indices to the front, in score order; overflow goes to a
    # drop column at post_max_size
    rank = torch.cumsum(keep, dim=-1) - 1
    pos = torch.where(keep, rank, post_max_size).clamp(max=post_max_size)
    out = torch.full((*order.shape[:-1], post_max_size + 1), -1, dtype=torch.int32,
                     device=boxes.device)
    out.scatter_(-1, pos, order.to(torch.int32))
    out = out[..., :post_max_size].contiguous()
    keep_count = torch.clamp(keep.sum(-1), max=post_max_size).to(torch.int32)
    return out, keep_count


def class_agnostic_nms(boxes, scores, valid_mask, nms_cfg, score_thresh=None):
    """Config-driven NMS (a ``score_thresh`` cut where one is given,
    NMS_PRE_MAXSIZE pre-selection, rotated NMS, NMS_POST_MAXSIZE cap) with
    fixed shapes.

    Returns keep_idx (..., NMS_POST_MAXSIZE) into the input order (-1 pad)
    and keep_count (...).
    """
    nms_type = str(nms_cfg.get("NMS_TYPE", "nms_gpu"))
    if nms_type != "nms_gpu":
        raise NotImplementedError(f"NMS_TYPE {nms_type!r} is not ported yet (ROADMAP A11.3)")
    if score_thresh is not None:
        valid_mask = valid_mask & (scores >= score_thresh)
    pre_max = int(nms_cfg["NMS_PRE_MAXSIZE"])
    post_max = int(nms_cfg["NMS_POST_MAXSIZE"])
    impl_cap = int(nms_cfg.get("NMS_IMPL_MAX_CANDIDATES", 0))
    if impl_cap > 0:
        pre_max = min(pre_max, impl_cap)
    thresh = float(nms_cfg["NMS_THRESH"])

    if boxes.shape[-2] <= pre_max:
        return nms_bev(boxes[..., :7], scores, valid_mask, thresh, post_max_size=post_max)
    order = torch.argsort(-torch.where(valid_mask, scores, float("-inf")), dim=-1,
                          stable=True)[..., :pre_max]
    sel_boxes = torch.gather(boxes[..., :7], -2, order[..., None].expand(*order.shape, 7))
    keep_idx, keep_count = nms_bev(sel_boxes, torch.gather(scores, -1, order),
                                   torch.gather(valid_mask, -1, order), thresh,
                                   post_max_size=post_max)
    mapped = torch.gather(order, -1, keep_idx.clamp(min=0).long())
    return torch.where(keep_idx >= 0, mapped, -1).to(torch.int32), keep_count
