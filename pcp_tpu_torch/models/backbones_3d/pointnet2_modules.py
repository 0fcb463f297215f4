"""PointNet++ set abstraction and feature propagation: counterpart of
``pcp_tpu/models/backbones_3d/pointnet2_modules.py``.

Multi-scale grouping (FPS centroids, ball-query groups of relative xyz and
features, a shared MLP, max or average pooling over the group) and
inverse-distance 3-NN propagation, over the padded channel-last layout
(B, N, C) with validity masks; BN statistics come from the valid slots only
(``MaskedBatchNorm``, momentum 0.1, eps 1e-5). The JAX package's padding
rules: a padding query gives zeros and a False mask, an empty ball gives
zeros. pcdet's names: ``mlps.{i}.{3j}`` (a 1x1 layer, here a ``Linear``),
``mlps.{i}.{3j+1}`` (its BN) and, without BN (PointRCNN's head, ``USE_BN:
False``), ``mlps.{i}.{2j}`` (a biased ``Linear``) before its ReLU. The
ball queries take their (B, M, N) squared distances a block of query rows at
a time, at most ``QUERY_BLOCK_ENTRIES`` of them (PV-RCNN's grid pool asks
64800 queries a sample of 4096 keypoints): each row's indices are those of
the whole matrix.
"""
import torch
from torch import nn

from ...ops import pointnet2 as pn2
from ..model_utils.norm import MaskedBatchNorm

QUERY_BLOCK_ENTRIES = 1 << 26


def ball_query_blocks(radii, nsamples, xyz, new_xyz, mask, new_mask):
    """Each radius' ``pn2.ball_query`` of every query of ``new_xyz``, the
    squared distances taken once a block of query rows -> [(idx, empty)]."""
    b, m, n = xyz.shape[0], new_xyz.shape[1], xyz.shape[1]
    rows = max(1, QUERY_BLOCK_ENTRIES // max(1, b * n))
    blocks = []
    for lo in range(0, m, rows):
        q, qm = new_xyz[:, lo:lo + rows], new_mask[:, lo:lo + rows]
        d2 = pn2.square_distance(q, xyz, a_mask=qm, b_mask=mask)
        blocks.append([pn2.ball_query(r, s, xyz, q, mask=mask, new_mask=qm, d2=d2)
                       for r, s in zip(radii, nsamples)])
    if len(blocks) == 1:
        return blocks[0]
    return [tuple(torch.cat([blk[i][j] for blk in blocks], dim=1) for j in range(2))
            for i in range(len(radii))]


class SharedMLP(nn.Sequential):
    """[Linear + (BN) + ReLU] per width of ``channels[1:]``, channel-last;
    ``use_bn=False`` gives biased Linears."""

    def __init__(self, channels, use_bn=True):
        layers = []
        for c_in, c_out in zip(channels[:-1], channels[1:]):
            layers.append(nn.Linear(c_in, c_out, bias=not use_bn))
            if use_bn:
                layers.append(MaskedBatchNorm(c_out, eps=1e-5, momentum=0.1))
            layers.append(nn.ReLU())
        super().__init__(*layers)

    def forward(self, x, mask=None):
        for layer in self:
            x = layer(x, mask) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction; ``npoint=None`` groups the whole
    cloud into one descriptor (GroupAll). ``mlps`` are each scale's widths
    without the input's."""

    def __init__(self, npoint, radii, nsamples, mlps, in_channels, use_xyz=True,
                 pool_method="max_pool", use_bn=True):
        super().__init__()
        if pool_method not in ("max_pool", "avg_pool"):
            raise NotImplementedError(pool_method)
        self.npoint, self.radii, self.nsamples = npoint, list(radii), list(nsamples)
        self.use_xyz, self.pool_method = use_xyz, pool_method
        c_in = in_channels + 3 if use_xyz or in_channels == 0 else in_channels
        self.mlps = nn.ModuleList(SharedMLP([c_in] + list(m), use_bn=use_bn) for m in mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, mask=None, new_xyz=None, new_mask=None):
        """xyz (B, N, 3), features (B, N, C) or None, mask (B, N) bool ->
        (new_xyz (B, M, 3), new_features (B, M, sum of the last widths),
        new_mask (B, M))."""
        b, n, _ = xyz.shape
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
        if self.npoint is not None:
            if new_xyz is None:
                fps_idx = pn2.farthest_point_sample(xyz, self.npoint, mask)
                new_xyz = pn2.gather_points(xyz, fps_idx)
                new_mask = torch.gather(mask, 1, fps_idx)
            elif new_mask is None:
                new_mask = torch.ones(new_xyz.shape[:2], dtype=torch.bool, device=xyz.device)
            # one distance matrix a block of queries serves every radius
            queries = ball_query_blocks(self.radii, self.nsamples, xyz, new_xyz, mask, new_mask)
        else:
            new_xyz = xyz.new_zeros((b, 1, 3))
            new_mask = torch.ones((b, 1), dtype=torch.bool, device=xyz.device)

        outs = []
        for i, mlp in enumerate(self.mlps):
            if self.npoint is not None:
                idx, empty = queries[i]
                parts = [pn2.group_points(xyz, idx) - new_xyz[:, :, None, :]]
                if features is not None:
                    parts.append(pn2.group_points(features, idx))
                slot_mask = ((~empty)[..., None] & new_mask[..., None]).expand(*idx.shape)
            else:
                parts = [xyz[:, None]]
                if features is not None:
                    parts.append(features[:, None])
                slot_mask = mask[:, None, :]
            grouped = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            if not self.use_xyz and features is not None:
                grouped = grouped[..., 3:]
            h = mlp(grouped, slot_mask)
            if self.pool_method == "max_pool":
                # amax shares the gradient among tied maxima, as jnp.max
                h = torch.amax(torch.where(slot_mask[..., None], h, float("-inf")), dim=2)
                h = torch.where(torch.isfinite(h), h, 0.0)
            else:
                cnt = torch.clamp(slot_mask.sum(dim=2), min=1)
                h = torch.where(slot_mask[..., None], h, 0.0).sum(dim=2) / cnt[..., None]
            outs.append(h)
        new_features = torch.where(new_mask[..., None], torch.cat(outs, dim=-1), 0.0)
        return new_xyz, new_features, new_mask


class PointnetFPModule(nn.Module):
    """Inverse-distance-weighted 3-NN propagation and a shared MLP."""

    def __init__(self, mlp):
        super().__init__()
        self.mlp = SharedMLP(list(mlp))

    def forward(self, unknown, known, unknow_feats, known_feats, unknown_mask=None,
                known_mask=None):
        """unknown (B, n, 3), known (B, m, 3) or None, features channel-last."""
        if known is not None:
            dist, idx = pn2.three_nn(unknown, known, known_mask=known_mask)
            recip = 1.0 / (dist + 1e-8)
            weight = recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])
            interp = pn2.three_interpolate(known_feats, idx, weight)
        else:
            interp = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                        known_feats.shape[-1])
        h = interp if unknow_feats is None else torch.cat([interp, unknow_feats], dim=-1)
        h = self.mlp(h, unknown_mask)
        if unknown_mask is not None:
            h = torch.where(unknown_mask[..., None], h, 0.0)
        return h
