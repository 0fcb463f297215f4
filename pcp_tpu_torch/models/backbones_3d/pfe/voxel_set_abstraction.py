"""Voxel set abstraction, PV-RCNN's keypoint features: counterpart of
``pcp_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py``.

``NUM_KEYPOINTS`` keypoints by farthest point sampling over the valid raw
points (a cloud with fewer valid points repeats them; ``point_coords_mask``
marks the keypoints that are padding rows, as ``take_along_axis(mask,
kp_idx)`` does in the JAX package). Each source of ``FEATURES_SOURCE`` gives
a feature a keypoint: ``bev`` the BEV map bilinearly sampled at the keypoint
(the four corners clamped to the map), ``raw_points`` and each level of the
sparse 3D backbone (``x_conv3``, ``x_conv4``: its voxel centres) a
multi-scale set abstraction about the keypoints (``PointnetSAModuleMSG``
with the keypoints as ``new_xyz``). The concatenation
(``point_features_before_fusion``) goes through a Linear without bias, a BN
over the valid keypoints (momentum 0.1) and a ReLU into ``point_features``.
pcdet's names: ``SA_rawpoints``, ``SA_layers.{k}`` (the backbone levels in
``FEATURES_SOURCE`` order), ``vsa_point_feature_fusion.{0,1}``. Levels that
``SA_LAYER`` lists but ``FEATURES_SOURCE`` does not name are built by
neither package. The voxel centres are ``(index + 0.5) * voxel * stride +
range_min`` with the multiply-add rounded once, as XLA's fused CPU code
rounds it.

PV-RCNN++: a source whose ``NAME`` is ``VectorPoolAggregationModuleMSG``
aggregates through VectorPool instead (``vector_pool.py``), and
``SAMPLE_METHOD: SPC`` takes the keypoints by FPS over the candidates near
a proposal only: the valid points whose distance to the nearest ROI's
centre is below half that ROI's diagonal plus
``SPC_SAMPLING.SAMPLE_RADIUS_WITH_ROI`` (all valid points where none is);
pcdet's sectors only split its CUDA FPS, as the JAX package notes.
"""
import torch
from torch import nn

from ....ops import pointnet2 as pn2
from ....ops import sparse3d
from ...model_utils.norm import MaskedBatchNorm
from ..pointnet2_modules import PointnetSAModuleMSG
from ..vector_pool import VectorPoolAggregationModuleMSG


def get_voxel_centers_from_ids(ids, dims, downsample, voxel_size, pc_range):
    """Sorted flat ids (B, V) of a level of ``dims`` (nz, ny, nx) -> voxel
    centres (B, V, 3) xyz and their validity (B, V)."""
    nz, ny, nx = dims
    valid = ids < nz * ny * nx
    z, y, x = sparse3d.decode_ids(torch.where(valid, ids, 0), dims)
    vs = torch.tensor([float(v) for v in voxel_size[:3]], device=ids.device) * float(downsample)
    mins = torch.tensor([float(v) for v in pc_range[0:3]], device=ids.device)
    centers = torch.stack([x, y, z], dim=-1).to(torch.float32)
    return pn2.fma(centers + 0.5, vs, mins), valid


def bilinear_interpolate_bev(bev, xy):
    """bev (B, C, H, W), xy (B, K, 2) fractional (x, y) map coordinates ->
    (B, K, C): the four neighbours' weighted sum, each corner index clamped
    to the map."""
    b, c, h, w = bev.shape
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    flat = bev.reshape(b, c, h * w)

    def gather(yi, xi):
        return torch.gather(flat, 2, (yi * w + xi)[:, None, :].expand(-1, c, -1)).transpose(1, 2)

    x0f, x1f, y0f, y1f = (v.to(xy.dtype) for v in (x0, x1, y0, y1))
    wa = ((x1f - x) * (y1f - y))[..., None]
    wb = ((x1f - x) * (y - y0f))[..., None]
    wc = ((x - x0f) * (y1f - y))[..., None]
    wd = ((x - x0f) * (y - y0f))[..., None]
    return (gather(y0, x0) * wa + gather(y1, x0) * wb + gather(y0, x1) * wc
            + gather(y1, x1) * wd)


def _sa_module(src_cfg, num_keypoints, in_channels):
    if src_cfg.get("NAME") == "VectorPoolAggregationModuleMSG":
        return VectorPoolAggregationModuleMSG(in_channels, src_cfg)
    return PointnetSAModuleMSG(
        npoint=num_keypoints, radii=[float(r) for r in src_cfg["POOL_RADIUS"]],
        nsamples=[int(n) for n in src_cfg["NSAMPLE"]], mlps=[list(m) for m in src_cfg["MLPS"]],
        in_channels=in_channels)


def _aggregate(module, xyz, feats, mask, keypoints, kp_mask):
    if isinstance(module, VectorPoolAggregationModuleMSG):
        return module(xyz, feats, mask, keypoints, kp_mask)
    return module(xyz, feats, mask=mask, new_xyz=keypoints, new_mask=kp_mask)[1]


def spc_candidates(xyz, mask, rois, sample_radius):
    """The valid points (B, N) near a proposal of ``rois`` (B, R, 7+): the
    nearest valid ROI's centre closer than half its diagonal plus
    ``sample_radius``; all valid points of a cloud where none is."""
    rois = rois[..., :7]
    d = pn2.norm3(xyz[:, :, None, :] - rois[:, None, :, 0:3])  # (B, N, R)
    d = torch.where(torch.any(rois != 0, dim=-1)[:, None, :], d, 1e9)
    min_d, nearest = d.min(dim=-1)  # the first of tied minima
    half = torch.gather(rois[..., 3:6], 1, nearest[..., None].expand(-1, -1, 3)) / 2
    cand = mask & (min_d < pn2.norm3(half) + float(sample_radius))
    return torch.where(torch.any(cand, dim=1, keepdim=True), cand, mask)


class VoxelSetAbstraction(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range, num_bev_features,
                 num_rawpoint_features, level_channels):
        super().__init__()
        self.model_cfg = model_cfg
        if model_cfg.get("POINT_SOURCE", "raw_points") != "raw_points":
            raise NotImplementedError(f"POINT_SOURCE {model_cfg['POINT_SOURCE']!r}")
        self.sample_method = model_cfg.get("SAMPLE_METHOD", "FPS")
        if self.sample_method not in ("FPS", "SPC"):
            raise NotImplementedError(f"SAMPLE_METHOD {self.sample_method!r}")
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.num_keypoints = int(model_cfg["NUM_KEYPOINTS"])
        self.sources = list(model_cfg["FEATURES_SOURCE"])
        sa_cfg = model_cfg["SA_LAYER"]
        width = 0
        if "bev" in self.sources:
            width += int(num_bev_features)
        self.levels = [s for s in self.sources if s not in ("bev", "raw_points")]
        self.SA_layers = nn.ModuleList()
        for src in self.levels:
            sa = _sa_module(sa_cfg[src], self.num_keypoints, int(level_channels[src]))
            self.SA_layers.append(sa)
            width += sa.out_channels
        if "raw_points" in self.sources:
            self.SA_rawpoints = _sa_module(sa_cfg["raw_points"], self.num_keypoints,
                                           max(int(num_rawpoint_features) - 3, 0))
            width += self.SA_rawpoints.out_channels
        self.num_point_features_before_fusion = width
        self.num_point_features = int(model_cfg["NUM_OUTPUT_FEATURES"])
        self.vsa_point_feature_fusion = nn.Sequential(
            nn.Linear(width, self.num_point_features, bias=False),
            MaskedBatchNorm(self.num_point_features, eps=1e-5, momentum=0.1), nn.ReLU())

    def forward(self, batch):
        out = dict(batch)
        points, mask = out["points"], out["points_mask"]
        xyz = points[..., 0:3]
        cand = mask
        if self.sample_method == "SPC":
            cand = spc_candidates(xyz, mask, out["rois"],
                                  self.model_cfg["SPC_SAMPLING"]["SAMPLE_RADIUS_WITH_ROI"])
        kp_idx = pn2.farthest_point_sample(xyz, self.num_keypoints, cand)
        kp_mask = torch.gather(cand, 1, kp_idx)
        keypoints = pn2.gather_points(xyz, kp_idx)

        feats = []
        if "bev" in self.sources:
            # float32 constants, as the JAX package's, whatever the points' dtype
            vs = torch.tensor(self.voxel_size[0:2], device=xyz.device).to(xyz.dtype)
            mins = torch.tensor(self.point_cloud_range[0:2], device=xyz.device).to(xyz.dtype)
            stride = torch.tensor(float(out.get("spatial_features_stride", 8)),
                                  device=xyz.device).to(xyz.dtype)
            xy = (keypoints[..., 0:2] - mins) / vs / stride
            feats.append(bilinear_interpolate_bev(out["spatial_features"], xy))
        if "raw_points" in self.sources:
            raw = points[..., 3:] if points.shape[-1] > 3 else None
            feats.append(_aggregate(self.SA_rawpoints, xyz, raw, mask, keypoints, kp_mask))
        sa_cfg = self.model_cfg["SA_LAYER"]
        for src, sa in zip(self.levels, self.SA_layers):
            ids, vfeat, dims, _ = out["multi_scale_3d_features"][src]
            centers, vvalid = get_voxel_centers_from_ids(
                ids, dims, int(sa_cfg[src]["DOWNSAMPLE_FACTOR"]), self.voxel_size,
                self.point_cloud_range)
            feats.append(_aggregate(sa, centers.to(xyz.dtype), vfeat, vvalid, keypoints, kp_mask))
        # the JAX package's concatenation order: bev, raw points, then the levels
        before = torch.cat(feats, dim=-1)
        linear, bn, relu = self.vsa_point_feature_fusion
        out["point_features_before_fusion"] = before
        out["point_features"] = relu(bn(linear(before), kp_mask))
        out["point_coords"] = keypoints
        out["point_coords_mask"] = kp_mask
        return out
