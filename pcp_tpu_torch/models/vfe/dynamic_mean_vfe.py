"""Dynamic mean VFE of the SECOND family: points -> a budget of voxels.

Counterpart of ``pcp_tpu/models/vfe/dynamic_mean_vfe.py``. Each point's voxel
id is taken on the (nz + 1)-slice grid of pcdet's ``sparse_shape``, in
float32 with the JAX package's operation order; padding and out-of-range
points take the id ``limit = (nz + 1) * ny * nx``. The points are sorted by
id (stably), each voxel's mean feature is its segment's total over its count
(``ops/sorted_segments.py``), and the first ``MAX_VOXELS`` voxels in id order
are kept (default ``min(N, 32768)``): ``voxel_ids`` (B, V) sorted, the unused
slots ``limit``, ``voxel_features`` (B, V, NUM_POINT_FEATURES) zero there, and
``sparse_dims`` (nz + 1, ny, nx).
"""
import torch
from torch import nn

from ...ops.sorted_segments import segment_total_to_points, sort_by_pid


class DynamicMeanVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size, grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = int(model_cfg.get("NUM_POINT_FEATURES", num_point_features))
        self.grid_size = tuple(int(v) for v in grid_size)
        self.register_buffer("voxel_size", torch.tensor([float(v) for v in voxel_size[:3]]),
                             persistent=False)
        self.register_buffer("pc_lo", torch.tensor([float(v) for v in point_cloud_range[:3]]),
                             persistent=False)

    def forward(self, batch):
        nx, ny, nz = self.grid_size
        nzp = nz + 1  # pcdet's sparse_shape adds one z slice
        limit = nzp * ny * nx
        points = batch["points"][..., :self.num_point_features]
        b, n = points.shape[:2]
        coords = torch.floor((points[..., 0:3] - self.pc_lo) / self.voxel_size).to(torch.int64)
        in_range = ((coords[..., 0] >= 0) & (coords[..., 0] < nx) & (coords[..., 1] >= 0)
                    & (coords[..., 1] < ny) & (coords[..., 2] >= 0) & (coords[..., 2] < nz))
        valid = batch["points_mask"] & in_range
        vid = (coords[..., 2] * ny + coords[..., 1]) * nx + coords[..., 0]
        vid = torch.where(valid, vid, limit)

        vid_s, (pts_s,), _ = sort_by_pid(vid, [points])
        valid_s = vid_s < limit
        ones = valid_s[..., None].to(points.dtype)
        sums = segment_total_to_points(torch.cat([pts_s * ones, ones], dim=-1), vid_s)
        means = sums[..., :-1] / torch.clamp(sums[..., -1:], min=1.0)

        budget = int(self.model_cfg.get("MAX_VOXELS", min(n, 32768)))
        is_first = torch.ones_like(valid_s)
        is_first[:, 1:] = vid_s[:, 1:] != vid_s[:, :-1]
        is_first &= valid_s
        key = torch.where(is_first, torch.arange(n, device=vid.device), n)
        order = torch.sort(key, dim=1, stable=True)[1][:, :budget]
        ids = torch.gather(torch.where(is_first, vid_s, limit), 1, order)
        feats = torch.gather(means, 1, order[..., None].expand(-1, -1, means.shape[-1]))
        out = dict(batch)
        out["voxel_ids"] = ids
        out["voxel_features"] = torch.where((ids < limit)[..., None], feats, 0.0)
        out["sparse_dims"] = (nzp, ny, nx)
        return out
