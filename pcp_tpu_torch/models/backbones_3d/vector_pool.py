"""VectorPool aggregation, PV-RCNN++'s local-vector features: counterpart of
``pcp_tpu/models/backbones_3d/vector_pool.py``.

About every query point a (kx, ky, kz) lattice of local voxel centres
(:func:`local_voxel_offsets`) samples the support set, the first
``NEIGHBOR_NSAMPLE`` support points within ``MAX_NEIGHBOR_DISTANCE *
neighbor_distance_multiplier`` of the query (a ball query, its distances a
block of queries at a time):
``local_interpolation`` interpolates the support features at each centre
from its three nearest neighbours by inverse distance and appends the
three neighbours' positions about the centre (9 channels);
``voxel_avg_pool`` averages the features and positions of the support
points whose nearest centre it is. A linear map per local voxel (pcdet's
grouped 1x1 layer, ``groups`` = the lattice's size), a BN over the valid
queries and a ReLU, then the post MLPs; a padding query gives zeros. The
input features first go through a Linear without bias (``reduce``) to
``NUM_REDUCED_CHANNELS`` where their width differs, as in the JAX package.
pcdet's names: ``separate_local_aggregation_layer`` (weight (V * C_out,
C_in, 1)), ``separate_local_aggregation_bn``, ``post_mlps.{3i}`` /
``.{3i+1}``; the multi-group module's ``layer_{k}`` and
``msg_post_mlps``. The neighbours' distances to the centres are
``pn2.norm3`` (the JAX package's jitted rounding), and the three nearest
are taken by a stable sort, ties to the lower slot as ``lax.top_k``.
"""
import numpy as np
import torch
from torch import nn

from ...ops import pointnet2 as pn2
from ..model_utils.norm import MaskedBatchNorm
from .pointnet2_modules import SharedMLP, ball_query_blocks


def local_voxel_offsets(num_local_voxel, max_dist):
    """Centres of the local voxel lattice about the query (V, 3) float32,
    x outer."""
    def axis(n):
        return (np.arange(n) + 0.5) / n * 2 * max_dist - max_dist
    gx, gy, gz = np.meshgrid(*(axis(n) for n in num_local_voxel), indexing="ij")
    return torch.from_numpy(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32))


class VectorPoolAggregation(nn.Module):
    def __init__(self, input_channels, num_local_voxel=(3, 3, 3),
                 local_aggregation_type="local_interpolation", num_reduced_channels=30,
                 num_channels_of_local_aggregation=32, post_mlps=(128,),
                 max_neighbor_distance=1.0, neighbor_nsample=32,
                 neighbor_distance_multiplier=2.0):
        super().__init__()
        if local_aggregation_type not in ("local_interpolation", "voxel_avg_pool"):
            raise NotImplementedError(local_aggregation_type)
        self.local_aggregation_type = local_aggregation_type
        self.register_buffer("voxel_offsets",
                             local_voxel_offsets(num_local_voxel, max_neighbor_distance),
                             persistent=False)
        v = self.voxel_offsets.shape[0]
        cr = int(num_reduced_channels or input_channels)
        self.reduce = (nn.Linear(int(input_channels), cr, bias=False)
                       if int(input_channels) != cr else None)
        self.nsample = int(neighbor_nsample) if int(neighbor_nsample) > 0 else 32
        self.radius = float(max_neighbor_distance) * float(neighbor_distance_multiplier)
        local_width = cr + (9 if local_aggregation_type == "local_interpolation" else 3)
        cl = int(num_channels_of_local_aggregation)
        self.num_local_voxels, self.local_channels = v, cl
        self.separate_local_aggregation_layer = nn.Conv1d(v * local_width, v * cl, 1, groups=v,
                                                          bias=False)
        self.separate_local_aggregation_bn = MaskedBatchNorm(v * cl, eps=1e-5, momentum=0.1)
        self.post_mlps = SharedMLP([v * cl] + [int(c) for c in post_mlps])
        self.out_channels = int(post_mlps[-1]) if len(post_mlps) else v * cl

    def forward(self, xyz, feats, mask, new_xyz, new_mask):
        """xyz (B, N, 3), feats (B, N, C), mask (B, N), new_xyz (B, Q, 3),
        new_mask (B, Q) -> (B, Q, out_channels)."""
        if self.reduce is not None:
            feats = self.reduce(feats)
        [(idx, empty)] = ball_query_blocks([self.radius], [self.nsample], xyz, new_xyz, mask,
                                           new_mask)
        n_xyz = pn2.group_points(xyz, idx) - new_xyz[:, :, None, :]  # (B, Q, S, 3)
        n_feat = pn2.group_points(feats, idx)  # (B, Q, S, C)
        slot_ok = (~empty & new_mask)[:, :, None, None]  # (B, Q, 1, 1)
        off = self.voxel_offsets.to(n_xyz.dtype)
        # every neighbour's distance to every local voxel centre: (B, Q, V, S)
        d = pn2.norm3(n_xyz[:, :, None, :, :] - off[None, None, :, None, :])
        d = torch.where(slot_ok, d, 1e9)
        if self.local_aggregation_type == "local_interpolation":
            dist3, nn3 = (t[..., :3] for t in torch.sort(d, dim=-1, stable=True))
            recip = 1.0 / (torch.clamp(dist3, min=0.0) + 1e-8)
            w = recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])
            b, q, v = nn3.shape[:3]

            def take(t):  # (B, Q, S, C) at nn3 -> (B, Q, V, 3, C)
                flat = nn3.reshape(b, q, v * 3)[..., None].expand(-1, -1, -1, t.shape[-1])
                return torch.gather(t, 2, flat).reshape(b, q, v, 3, t.shape[-1])

            f3, wt = take(n_feat), w[..., None].to(n_feat.dtype)
            interp = pn2.fma(f3[..., 2, :], wt[..., 2, :],
                             pn2.fma(f3[..., 1, :], wt[..., 1, :], f3[..., 0, :] * wt[..., 0, :]))
            pos = (take(n_xyz) - off[None, None, :, None, :]).reshape(b, q, v, 9)
            local = torch.cat([interp, pos], dim=-1)  # (B, Q, V, C + 9)
        else:
            cell = torch.argmin(d, dim=2)  # (B, Q, S): each neighbour's nearest centre
            onehot = (cell[:, :, None, :] == torch.arange(
                d.shape[2], device=d.device)[None, None, :, None]) & slot_ok
            onehot = onehot.to(n_feat.dtype)  # (B, Q, V, S)
            cnt = torch.clamp(onehot.sum(dim=-1, keepdim=True), min=1.0)
            meanf = torch.einsum("bqvs,bqsc->bqvc", onehot, n_feat) / cnt
            meanp = torch.einsum("bqvs,bqsc->bqvc", onehot, n_xyz) / cnt
            local = torch.cat([meanf, meanp - off[None, None]], dim=-1)  # (B, Q, V, C + 3)
        v, cl = self.num_local_voxels, self.local_channels
        weight = self.separate_local_aggregation_layer.weight.reshape(v, cl, local.shape[-1])
        h = torch.einsum("bqvc,vdc->bqvd", local, weight).reshape(*local.shape[:2], v * cl)
        h = torch.relu(self.separate_local_aggregation_bn(h, new_mask))
        h = self.post_mlps(h, new_mask)
        return torch.where(new_mask[..., None], h, 0.0)


class VectorPoolAggregationModuleMSG(nn.Module):
    """One :class:`VectorPoolAggregation` a ``GROUP_CFG_{k}`` of ``config``,
    their outputs concatenated and passed through ``MSG_POST_MLPS``."""

    def __init__(self, input_channels, config):
        super().__init__()
        k, width = 0, 0
        while f"GROUP_CFG_{k}" in config:
            gc = config[f"GROUP_CFG_{k}"]
            layer = VectorPoolAggregation(
                input_channels=input_channels, num_local_voxel=tuple(gc["NUM_LOCAL_VOXEL"]),
                local_aggregation_type=config.get("LOCAL_AGGREGATION_TYPE",
                                                  "local_interpolation"),
                num_reduced_channels=gc.get("NUM_REDUCED_CHANNELS",
                                            config.get("NUM_REDUCED_CHANNELS")),
                num_channels_of_local_aggregation=int(config["NUM_CHANNELS_OF_LOCAL_AGGREGATION"]),
                post_mlps=tuple(gc["POST_MLPS"]),
                max_neighbor_distance=float(gc["MAX_NEIGHBOR_DISTANCE"]),
                neighbor_nsample=int(gc.get("NEIGHBOR_NSAMPLE", -1)))
            self.add_module(f"layer_{k}", layer)
            width += layer.out_channels
            k += 1
        self.num_groups = k
        msg = [int(c) for c in config.get("MSG_POST_MLPS", [])]
        self.msg_post_mlps = SharedMLP([width] + msg)
        self.out_channels = msg[-1] if msg else width

    def forward(self, xyz, feats, mask, new_xyz, new_mask):
        h = torch.cat([getattr(self, f"layer_{k}")(xyz, feats, mask, new_xyz, new_mask)
                       for k in range(self.num_groups)], dim=-1)
        h = self.msg_post_mlps(h, new_mask)
        return torch.where(new_mask[..., None], h, 0.0)
