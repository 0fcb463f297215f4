"""DiscoNet mid fusion.

Counterpart of ``pcp_tpu/models/bev_layers/v2x_fusion_disco.py``: the ego's
BEV and each agent's BEV (``bev_img``, from the frozen makers) go through
one shared compressor; each agent's is warped into the ego frame, a pixel
weightor scores every (ego, agent) pair, and the softmax over agents of
those scores weights the sum, which the decompressor brings back to the
backbone's width. In training, with an early-fusion teacher BEV
(``bev_img_early``), ``distill_loss`` is the smooth-L1 between the channel
softmaxes of the fused and the teacher BEV, times 10: under a process group
of more than one rank, this rank's sum over the global batch's element count
(``parallel/collective.py``'s rule).

Maps are (B, C, H, W); the softmaxes run over the JAX package's axes
(channels for the distillation loss, agents for the weights). BNs follow
flax's convention (``norm.BatchNorm2d``, flax momentum 0.9 = torch momentum
0.1, eps 1e-5, biased running variance); the compressor and the weightor
are reached once for the ego and once for each agent, so a training forward
updates their running statistics six times in turn, as flax does.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.collective import all_reduce_sum
from ..model_utils.norm import BatchNorm2d
from .hunter_jr import smooth_l1


def _f32(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def warp_source_coords(dst_se3_src, h, w, pc_range_min, pix_size):
    """The source pixel coordinates (B, H, W) x and y that the warp of
    :func:`transform_bev_img` samples, before rounding: the JAX package's
    arithmetic (normalised output-pixel centres, align_corners=False,
    through [R^T | -R^T t_norm]) in its order, dividing by float32 tensors."""
    rot = dst_se3_src[:, :2, :2]
    t = dst_se3_src[:, :2, 3]
    t_norm = 2.0 * ((t - _f32(pc_range_min, t)) / _f32(pix_size, t)) / _f32(h, t) - 1.0
    xs = (2.0 * torch.arange(w, device=t.device, dtype=torch.float32) + 1.0) / _f32(w, t) - 1.0
    ys = (2.0 * torch.arange(h, device=t.device, dtype=torch.float32) + 1.0) / _f32(h, t) - 1.0
    dx = xs[None, None, :] - t_norm[:, 0, None, None]  # (B, 1, W)
    dy = ys[None, :, None] - t_norm[:, 1, None, None]  # (B, H, 1)
    # src_i = sum_j R^T[i, j] * d_j = R[0, i] * dx + R[1, i] * dy
    sx = rot[:, 0, 0, None, None] * dx + rot[:, 1, 0, None, None] * dy
    sy = rot[:, 0, 1, None, None] * dx + rot[:, 1, 1, None, None] * dy
    px = ((sx + 1.0) * _f32(w, t) - 1.0) / _f32(2.0, t)
    py = ((sy + 1.0) * _f32(h, t) - 1.0) / _f32(2.0, t)
    return px, py


def transform_bev_img(dst_se3_src, bev_in_src, pc_range_min, pix_size):
    """Warp source-frame BEV images (B, C, H, W) into the destination frame
    given by ``dst_se3_src`` (B, 4, 4), with nearest sampling
    (``torch.round``: half to even, as ``jnp.round``); pixels that sample
    outside the source image are 0."""
    b, c, h, w = bev_in_src.shape
    px, py = warp_source_coords(dst_se3_src, h, w, pc_range_min, pix_size)
    ix = torch.round(px).to(torch.int32)
    iy = torch.round(py).to(torch.int32)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w).long()
    flat = bev_in_src.permute(0, 2, 3, 1).reshape(b, h * w, c)
    sampled = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).reshape(b, h, w, c)
    out = torch.where(valid[..., None], sampled, sampled.new_zeros(()))
    return out.permute(0, 3, 1, 2)


class PixelWeightedFusionSoftmax(nn.Module):
    """1x1 convs scoring each (ego, agent) pair of BEVs a pixel."""

    def __init__(self, channels):
        super().__init__()
        self.conv1_1 = nn.Conv2d(2 * channels, 64, 1)
        self.bn1_1 = BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.conv1_2 = nn.Conv2d(64, 16, 1)
        self.bn1_2 = BatchNorm2d(16, eps=1e-5, momentum=0.1)
        self.conv1_4 = nn.Conv2d(16, 1, 1)

    def forward(self, x):
        x = F.relu(self.bn1_1(self.conv1_1(x)))
        x = F.relu(self.bn1_2(self.conv1_2(x)))
        return F.relu(self.conv1_4(x))


class CompressBlock(nn.Module):
    """3x3 conv (no bias) -> BN -> ReLU -> 3x3 conv (bias)."""

    def __init__(self, c_in, mid, out):
        super().__init__()
        self.conv0 = nn.Conv2d(c_in, mid, 3, padding=1, bias=False)
        self.bn0 = BatchNorm2d(mid, eps=1e-5, momentum=0.1)
        self.conv1 = nn.Conv2d(mid, out, 3, padding=1, bias=True)

    def forward(self, x):
        return self.conv1(F.relu(self.bn0(self.conv0(x))))


class V2XMidFusionDisco(nn.Module):
    def __init__(self, model_cfg, info, num_bev_features):
        super().__init__()
        ch = int(model_cfg["COMPRESSED_CHANNELS"])
        self.compressor = CompressBlock(num_bev_features, ch, ch)
        self.pixel_weightor = PixelWeightedFusionSoftmax(ch)
        self.decompressor = CompressBlock(ch, num_bev_features, num_bev_features)
        self.pc_min = float(model_cfg.get("PC_RANGE_MIN", info.point_cloud_range[0]))
        stride = 4  # the pillar backbone's final BEV stride
        self.pix_size = float(model_cfg.get("FINAL_BEV_PIXEL_SIZE", info.voxel_size[0] * stride))

    def forward(self, batch):
        out = dict(batch)
        ego_bev = self.compressor(batch["spatial_features_2d"])
        all_bev = [ego_bev]
        all_w = [self.pixel_weightor(torch.cat([ego_bev, ego_bev], dim=1))]
        se3_from_ego = batch.get("se3_from_ego_arr")  # (B, 6, 4, 4)
        agent_present = batch.get("agent_present")  # (B, 6) bool
        for agent in sorted(batch.get("bev_img", {})):
            bev = self.compressor(batch["bev_img"][agent])
            ego_se3_agent = torch.linalg.inv(se3_from_ego[:, agent])
            warped = transform_bev_img(ego_se3_agent, bev, self.pc_min, self.pix_size)
            if agent_present is not None:
                warped = torch.where(agent_present[:, agent, None, None, None], warped,
                                     warped.new_zeros(()))
            all_w.append(self.pixel_weightor(torch.cat([ego_bev, warped], dim=1)))
            all_bev.append(warped)

        weights = torch.softmax(torch.cat(all_w, dim=1), dim=1)  # (B, A, H, W)
        fused = (torch.stack(all_bev, dim=2) * weights[:, None]).sum(dim=2)
        fused = self.decompressor(fused)
        if self.training and "bev_img_early" in batch:
            diff = torch.softmax(fused, dim=1) - torch.softmax(batch["bev_img_early"], dim=1)
            err = smooth_l1(diff)
            out["distill_loss"] = err.sum() / all_reduce_sum(err.new_full((), err.numel())) * 10.0
        out["spatial_features_2d"] = fused
        return out
