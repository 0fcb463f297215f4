"""Dynamic pillar VFE: padded points -> dense pillar grid.

Counterpart of ``pcp_tpu/models/vfe/dynamic_pillar_vfe.py`` (its sorted
pipeline). Points are sorted by flat pillar id; per-pillar means and the
non-last PFN layers' max-pool go through sorted segment totals, and the last
layer's max-pool writes the dense BEV grid through one of the scatter-max
functions of ``ops/bev_scatter.py`` (a CUDA kernel each on the card), chosen
by ``PRE_REDUCE`` as in the JAX package: unset -> ``bev_scatter_max_sorted``,
``True`` -> ``..._prereduced``, ``"fused"`` -> ``..._fused``, ``"onehot"`` ->
``..._onehot`` (strings in any case). Features are [raw | f_cluster | f_center]
(+ distance); a PFN layer is Linear (no bias) -> BatchNorm(eps 1e-3) -> ReLU.
In training the BN takes its statistics over valid points only, and the
gradient flows through the segment max and the scatter function's
tie-splitting backward.
"""
import torch
from torch import nn

from ...ops.bev_scatter import (bev_scatter_max_sorted, bev_scatter_max_sorted_fused,
                                bev_scatter_max_sorted_onehot,
                                bev_scatter_max_sorted_prereduced)
from ...ops.sorted_segments import segment_total_to_points, sort_by_pid
from ..model_utils.norm import MaskedBatchNorm


class PFNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, use_norm=True, last_layer=False):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_channels, out, bias=not use_norm)
        self.norm = MaskedBatchNorm(out, eps=1e-3, momentum=0.01) if use_norm else None

    def transform(self, x, valid):
        """Linear -> BN -> ReLU on (M, C_in) rows; in training the BN takes
        its statistics from the rows where ``valid`` (M,) is set."""
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x, valid)
        return torch.relu(x)


def pillar_ids(points, mask, point_cloud_range, voxel_size, grid_size):
    """(B, N) int32 flat pillar id, ``nx * ny`` for a padding or out-of-range
    point. Computed in float32 with the JAX package's operation order
    (``_coords_and_pid``) so that border points land in the same pillar."""
    rng = torch.tensor(point_cloud_range[0:2], dtype=torch.float32, device=points.device)
    vox = torch.tensor([float(voxel_size[0]), float(voxel_size[1])], dtype=torch.float32,
                       device=points.device)
    nx, ny = int(grid_size[0]), int(grid_size[1])
    coords = torch.floor((points[..., 0:2] - rng) / vox).to(torch.int32)
    in_range = ((coords[..., 0] >= 0) & (coords[..., 0] < nx)
                & (coords[..., 1] >= 0) & (coords[..., 1] < ny))
    return torch.where(mask & in_range, coords[..., 1] * nx + coords[..., 0], nx * ny).to(torch.int32)


def scatter_for(pre_reduce):
    """The scatter-max function that a ``PRE_REDUCE`` value selects."""
    if isinstance(pre_reduce, str) and pre_reduce.lower() == "onehot":
        return bev_scatter_max_sorted_onehot
    if isinstance(pre_reduce, str) and pre_reduce.lower() == "fused":
        return bev_scatter_max_sorted_fused
    if bool(pre_reduce):
        return bev_scatter_max_sorted_prereduced
    return bev_scatter_max_sorted


class DynamicPillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size, grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.scatter_max = scatter_for(model_cfg.get("PRE_REDUCE", False))
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.num_raw_point_features = int(model_cfg.get("NUM_RAW_POINT_FEATURES", None)
                                          or num_point_features)
        self.use_norm = bool(model_cfg["USE_NORM"])
        self.with_distance = bool(model_cfg["WITH_DISTANCE"])
        self.use_absolute_xyz = bool(model_cfg["USE_ABSLOTE_XYZ"])  # (sic, reference key)
        filters = list(model_cfg["NUM_FILTERS"])
        in_ch = (self.num_raw_point_features if self.use_absolute_xyz
                 else self.num_raw_point_features - 3) + 6 + int(self.with_distance)
        layers = []
        for i, f in enumerate(filters):
            layers.append(PFNLayer(in_ch, f, self.use_norm, last_layer=i == len(filters) - 1))
            in_ch = f
        self.pfn_layers = nn.ModuleList(layers)
        self.num_bev_features = filters[-1]

    def forward(self, batch):
        vx, vy, vz = self.voxel_size
        nx, ny = self.grid_size[0], self.grid_size[1]
        points = batch["points"][..., : self.num_raw_point_features]
        b, n = points.shape[0], points.shape[1]

        pid = pillar_ids(points, batch["points_mask"], self.point_cloud_range, self.voxel_size,
                         self.grid_size)
        pid_s, (points_s,), _ = sort_by_pid(pid, [points])
        valid_s = pid_s < nx * ny
        coords_s = torch.stack([(pid_s % nx).to(points.dtype),
                                torch.div(pid_s, nx, rounding_mode="floor").to(points.dtype)], -1)

        xyz = points_s[..., 0:3]
        ones = valid_s[..., None].to(points.dtype)
        sc = segment_total_to_points(torch.cat([xyz * ones, ones], -1), pid_s, "sum")
        f_cluster = xyz - sc[..., :3] / torch.clamp(sc[..., 3:4], min=1.0)

        x_offset = vx / 2 + self.point_cloud_range[0]
        y_offset = vy / 2 + self.point_cloud_range[1]
        z_offset = vz / 2 + self.point_cloud_range[2]
        f_center = torch.stack([xyz[..., 0] - (coords_s[..., 0] * vx + x_offset),
                                xyz[..., 1] - (coords_s[..., 1] * vy + y_offset),
                                xyz[..., 2] - z_offset], -1)

        feats = [points_s if self.use_absolute_xyz else points_s[..., 3:], f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        features = torch.cat(feats, -1)

        flat_valid = valid_s.reshape(b * n)
        for pfn in self.pfn_layers:
            features = pfn.transform(features.reshape(b * n, -1), flat_valid).reshape(b, n, -1)
            if not pfn.last_layer:
                back = segment_total_to_points(
                    torch.where(valid_s[..., None], features, 0.0), pid_s, "amax")
                features = torch.cat([features, back], -1)

        final = torch.where(valid_s[..., None], features, 0.0).contiguous()
        bev = self.scatter_max(final, pid_s.contiguous(), ny, nx)
        out = dict(batch)
        out["pillar_features"] = bev.reshape(b, ny * nx, -1)
        return out
