"""Rotated BEV box overlap and IoU, and 3D IoU.

Counterpart of ``boxes_overlap_bev`` / ``boxes_iou_bev`` / ``boxes_iou3d`` in
``pcp_tpu/ops/rotated_iou.py``, with the same edge-clip algorithm so that
pairs near an NMS threshold fall on the same side: the overlap's boundary is
the part of A's edges inside B plus the part of B's edges inside A, and the
shoelace sum is additive per directed edge. Coincident boundaries are handled
as there, by averaging a run with B shrunk by ``inset`` and a run with A
shrunk. Boxes are pcdet ``[x, y, z, dx, dy, dz, heading]``; every function
takes (..., N, 7) and (..., M, 7) and returns (..., N, M).
"""
import torch

EPS = 1e-8


def _edge_clip_contrib(boxes_a, boxes_b, inset):
    """Shoelace cross-contributions of A's edges clipped to B (shrunk by
    ``inset``), about the midpoint of the two centres, summed per pair."""
    big = 1e9
    xa, ya, yawa = boxes_a[..., :, None, 0], boxes_a[..., :, None, 1], boxes_a[..., :, None, 6]
    dxa, dya = boxes_a[..., :, None, 3], boxes_a[..., :, None, 4]
    xb, yb, yawb = boxes_b[..., None, :, 0], boxes_b[..., None, :, 1], boxes_b[..., None, :, 6]
    dxb, dyb = boxes_b[..., None, :, 3], boxes_b[..., None, :, 4]

    # A's centre and axes in B's local frame
    cb_, sb_ = torch.cos(yawb), torch.sin(yawb)
    rx, ry = xa - xb, ya - yb
    tx = cb_ * rx + sb_ * ry
    ty = -sb_ * rx + cb_ * ry
    th = yawa - yawb
    ct, st = torch.cos(th), torch.sin(th)

    hx = dxb * 0.5 - inset
    hy = dyb * 0.5 - inset
    ox, oy = tx * 0.5, ty * 0.5

    # CCW local corners of A: (+,+), (-,+), (-,-), (+,-) scaled by half-dims
    lxs = (0.5, -0.5, -0.5, 0.5)
    lys = (0.5, 0.5, -0.5, -0.5)
    cxs, cys = [], []
    for k in range(4):
        lx = dxa * lxs[k]
        ly = dya * lys[k]
        cxs.append(tx + lx * ct - ly * st)
        cys.append(ty + lx * st + ly * ct)

    total = torch.zeros_like(tx)
    for k in range(4):
        x0, y0 = cxs[k], cys[k]
        x1, y1 = cxs[(k + 1) % 4], cys[(k + 1) % 4]
        dx, dy = x1 - x0, y1 - y0

        par_x = torch.abs(dx) < EPS
        inv_dx = 1.0 / torch.where(par_x, EPS, dx)
        t1x = (-hx - x0) * inv_dx
        t2x = (hx - x0) * inv_dx
        in_x = torch.abs(x0) <= hx
        txmin = torch.where(par_x, torch.where(in_x, -big, big), torch.minimum(t1x, t2x))
        txmax = torch.where(par_x, torch.where(in_x, big, -big), torch.maximum(t1x, t2x))
        par_y = torch.abs(dy) < EPS
        inv_dy = 1.0 / torch.where(par_y, EPS, dy)
        t1y = (-hy - y0) * inv_dy
        t2y = (hy - y0) * inv_dy
        in_y = torch.abs(y0) <= hy
        tymin = torch.where(par_y, torch.where(in_y, -big, big), torch.minimum(t1y, t2y))
        tymax = torch.where(par_y, torch.where(in_y, big, -big), torch.maximum(t1y, t2y))

        t0 = torch.clamp(torch.maximum(txmin, tymin), min=0.0)
        t1 = torch.clamp(torch.minimum(txmax, tymax), max=1.0)
        hit = t1 > t0

        ux = x0 + t0 * dx - ox
        uy = y0 + t0 * dy - oy
        vx = x0 + t1 * dx - ox
        vy = y0 + t1 * dy - oy
        total = total + torch.where(hit, ux * vy - uy * vx, 0.0)
    return total


def boxes_overlap_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV overlap areas, (..., N, M)."""
    inset = 1e-4
    a_shrunk = _edge_clip_contrib(boxes_a, boxes_b, inset)
    a_full = _edge_clip_contrib(boxes_a, boxes_b, 0.0)
    b_shrunk = _edge_clip_contrib(boxes_b, boxes_a, inset).transpose(-1, -2)
    b_full = _edge_clip_contrib(boxes_b, boxes_a, 0.0).transpose(-1, -2)
    area = 0.5 * (0.5 * ((a_shrunk + b_full) + (a_full + b_shrunk)))
    max_area = torch.minimum((boxes_a[..., 3] * boxes_a[..., 4])[..., :, None],
                             (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :])
    return torch.minimum(torch.clamp(area, min=0.0), max_area)


def boxes_iou_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV IoU, (..., N, M)."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """Pairwise 3D IoU, (..., N, M): the rotated BEV overlap times the
    overlap of the z extents, over the union of the volumes."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_max = (boxes_a[..., 2] + boxes_a[..., 5] * 0.5)[..., :, None]
    a_min = (boxes_a[..., 2] - boxes_a[..., 5] * 0.5)[..., :, None]
    b_max = (boxes_b[..., 2] + boxes_b[..., 5] * 0.5)[..., None, :]
    b_min = (boxes_b[..., 2] - boxes_b[..., 5] * 0.5)[..., None, :]
    overlap_h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)
