"""Rotated BEV IoU and greedy NMS on the host, in numpy.

Counterpart of ``pcp_tpu/utils/nms_np.py``: Sutherland-Hodgman clipping of
one rectangle by the other. The ego dataset deduplicates the ground truth
merged from every agent with it (small box sets of varying size, at dataset
construction), and late fusion merges the agents' boxes with
:func:`nms_bev_np` or :func:`weighted_nms_bev_np`.
"""
import numpy as np


def rect_corners(box):
    x, y, dx, dy, yaw = box[0], box[1], box[3], box[4], box[6]
    c, s = np.cos(yaw), np.sin(yaw)
    out = np.empty((4, 2))
    for i, (lx, ly) in enumerate(
        [(dx / 2, dy / 2), (-dx / 2, dy / 2), (-dx / 2, -dy / 2), (dx / 2, -dy / 2)]
    ):
        out[i] = (x + lx * c - ly * s, y + lx * s + ly * c)
    return out


def _clip(poly, a, b):
    out = []
    n = len(poly)
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        sc = (b[0] - a[0]) * (cur[1] - a[1]) - (b[1] - a[1]) * (cur[0] - a[0])
        sn = (b[0] - a[0]) * (nxt[1] - a[1]) - (b[1] - a[1]) * (nxt[0] - a[0])
        if sc >= 0:
            out.append(cur)
        if (sc > 0) != (sn > 0) and sc != sn:
            out.append(cur + sc / (sc - sn) * (nxt - cur))
    return out


def overlap_bev(box_a, box_b):
    poly = list(rect_corners(box_a))
    cb = rect_corners(box_b)
    for i in range(4):
        poly = _clip(poly, cb[i], cb[(i + 1) % 4])
        if not poly:
            return 0.0
    p = np.asarray(poly)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def iou_bev(box_a, box_b):
    ov = overlap_bev(box_a, box_b)
    return ov / max(box_a[3] * box_a[4] + box_b[3] * box_b[4] - ov, 1e-6)


def nms_bev_np(boxes, scores, thresh):
    """Greedy rotated NMS; returns kept indices in descending score order."""
    order = np.argsort(-np.asarray(scores))
    suppressed = np.zeros(len(boxes), dtype=bool)
    keep = []
    # cheap center-distance prefilter: farther than the sum of half-diagonals
    # cannot overlap
    half_diag = 0.5 * np.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        for j in order:
            if j == i or suppressed[j]:
                continue
            if np.linalg.norm(boxes[i, :2] - boxes[j, :2]) > half_diag[i] + half_diag[j]:
                continue
            if iou_bev(boxes[i], boxes[j]) > thresh:
                suppressed[j] = True
    return np.asarray(keep, dtype=np.int64)


def weighted_nms_bev_np(boxes, scores, thresh):
    """Greedy rotated NMS with score-weighted box averaging: each keeper's
    geometry (x, y, z, dx, dy, dz, yaw) is replaced by the score-weighted mean
    over its suppressed cluster (yaws aligned to the keeper's mod 2pi, flipped
    by pi when opposed, then circularly averaged). Returns
    ``(fused_boxes (K, 7), keep_indices (K,))`` — keep order = descending
    score, so scores/labels follow from ``keep_indices``."""
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores)
    suppressed = np.zeros(len(boxes), dtype=bool)
    keep, fused = [], []
    half_diag = 0.5 * np.sqrt(boxes[:, 3] ** 2 + boxes[:, 4] ** 2)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        cluster = [i]
        for j in order:
            if j == i or suppressed[j]:
                continue
            if np.linalg.norm(boxes[i, :2] - boxes[j, :2]) > half_diag[i] + half_diag[j]:
                continue
            if iou_bev(boxes[i], boxes[j]) > thresh:
                suppressed[j] = True
                cluster.append(int(j))
        cb = boxes[cluster, :7].copy()
        w = scores[cluster]
        w = w / max(w.sum(), 1e-9)
        # heading: flip members opposed to the keeper, then weighted circular mean
        dyaw = cb[:, 6] - cb[0, 6]
        dyaw = (dyaw + np.pi) % (2 * np.pi) - np.pi
        flip = np.abs(dyaw) > np.pi / 2
        cb[flip, 6] += np.pi
        sin_m = np.sum(w * np.sin(cb[:, 6]))
        cos_m = np.sum(w * np.cos(cb[:, 6]))
        out = (w[:, None] * cb[:, :6]).sum(axis=0)
        fused.append(np.concatenate([out, [np.arctan2(sin_m, cos_m)]]))
    if not fused:
        return np.zeros((0, 7)), np.zeros((0,), dtype=np.int64)
    return np.stack(fused), np.asarray(keep, dtype=np.int64)
