"""First containing box of each point, in torch.

Counterpart of the host kernel the JAX package's exchange uses
(``pcp_tpu/native/pointcloud.cpp::points_in_boxes``, the semantics of
``roiaware_pool3d``'s ``points_in_boxes_gpu``): a point is inside a box when
its z lies within half the box's height of the box's *center* z and its xy,
turned into the box's frame, within half the box's length and width plus a
1e-5 margin. Float32 throughout, as the native path. Plain torch ops on
whatever device the tensors lie on: the (N, M) test is small next to the
forward (a few thousand foreground points against at most 83 boxes; 16384
points against a KITTI frame's gt or PointRCNN's 128 ROIs).
"""
import torch

MARGIN = 1e-5


def points_in_boxes_mask(points, boxes):
    """points (..., N, 3+), boxes (..., M, 7) [x, y, z, dx, dy, dz, heading]
    -> (..., N, M) bool, True where the point is inside the box. Computes in
    the dtype of ``boxes``."""
    rel = points[..., :, None, :3] - boxes[..., None, :, :3]  # (..., N, M, 3)
    c = torch.cos(boxes[..., 6])[..., None, :]
    s = torch.sin(boxes[..., 6])[..., None, :]
    lx = c * rel[..., 0] + s * rel[..., 1]
    ly = -s * rel[..., 0] + c * rel[..., 1]
    return ((rel[..., 2].abs() <= boxes[..., None, :, 5] * 0.5)
            & (lx.abs() < boxes[..., None, :, 3] * 0.5 + MARGIN)
            & (ly.abs() < boxes[..., None, :, 4] * 0.5 + MARGIN))


def first_box(inside):
    """(..., N, M) containment -> (..., N) int64 index of the first
    containing box, -1 where none."""
    if inside.shape[-1] == 0:
        return torch.full(inside.shape[:-1], -1, dtype=torch.int64, device=inside.device)
    first = torch.argmax(inside.to(torch.uint8), dim=-1)  # first True
    return torch.where(inside.any(dim=-1), first, -1)


def points_in_boxes(points, boxes):
    """points (N, 3+), boxes (M, 7) [x, y, z, dx, dy, dz, heading] ->
    (N,) int64 index of the first containing box, -1 where none."""
    return first_box(points_in_boxes_mask(points[:, :3].to(torch.float32),
                                          boxes[:, :7].to(torch.float32)))
