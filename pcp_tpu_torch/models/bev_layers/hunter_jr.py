"""HunterJr scene-flow corrector, serving half.

Counterpart of the eval branch of ``pcp_tpu/models/bev_layers/hunter_jr.py``
(``HunterJr.__call__`` and ``_correct_bev_image``): a 3x3 conv on the
backbone's BEV, per-point features sampled from it, a point head that
classifies each point (background / static / dynamic) and predicts its
scene flow, dynamic points moved by their flow and sampled again, the point
features mean-scattered into a corrected BEV, and a learned 2-way softmax
that blends the two images. Eval also emits ``points_cls_prob`` (sigmoid)
and ``points_flow3d``, which the exchange writer broadcasts.

Training (the object head, the corrector loss, the gt range filter) is not
ported yet: ``train()`` raises, naming ROADMAP A7b, so that nothing trains
the corrector partly.

Modules and names follow pcdet (``conv_input.{0,1}``,
``point_head.<mlp>.<idx>``, ``conv_weightor.0.{0,1}``, ``conv_weightor.1``).
Feature maps are (B, C, H, W); the gather and the scatter work on
channels-last copies, as the JAX package does.
"""
import torch
from torch import nn

from ..model_utils.norm import BatchNorm2d
from .hunter_toolbox import MLP, bev_scatter, bilinear_interpolate_bev

A7B = "HunterJr training is not ported yet (ROADMAP A7b)"


def conv_bn_relu(c_in, c_out):
    """3x3 conv without bias, flax-convention BN (eps 1e-3; flax momentum
    0.99 is torch momentum 0.01), ReLU."""
    return nn.Sequential(nn.Conv2d(c_in, c_out, 3, padding=1, bias=False),
                         BatchNorm2d(c_out, eps=1e-3, momentum=0.01), nn.ReLU())


class HunterPointHead(nn.Module):
    def __init__(self, num_point_features, hidden_channels=()):
        super().__init__()
        c = num_point_features
        self.local_feat_predictor = MLP(c, c, hidden_channels, is_head=False)
        self.seg = MLP(c, 3, hidden_channels)
        self.reg_flow3d = MLP(c, 3, hidden_channels)
        # read only by the training losses (A7b); kept for the weights
        self.instance_embedding = MLP(c, 2, hidden_channels)

    def forward(self, points_feat, valid):
        """(P, C) features -> class logits (P, 3), flow (P, 3)."""
        final_feat = points_feat + self.local_feat_predictor(points_feat, valid)
        return self.seg(final_feat, valid), self.reg_flow3d(final_feat, valid)


class HunterJr(nn.Module):
    def __init__(self, model_cfg, info, num_bev_features):
        super().__init__()
        self.thresh_point_cls_prob = float(model_cfg.get("THRESHOLD_POINT_CLS_PROB", 0.3))
        stride = int(model_cfg["BEV_IMAGE_STRIDE"])
        # the JAX order: float32 voxel size times the stride
        self.register_buffer("pixel_size",
                             torch.tensor(info.voxel_size[:2], dtype=torch.float32) * stride,
                             persistent=False)
        self.register_buffer("pc_range", torch.tensor(info.point_cloud_range, dtype=torch.float32),
                             persistent=False)
        c = num_bev_features  # the JAX package's width; CONV_INPUT_CHANNELS is not read
        self.conv_input = conv_bn_relu(c, c)
        self.point_head = HunterPointHead(c, tuple(model_cfg.get("POINT_HEAD_HIDDEN_CHANNELS", [])))
        self.conv_weightor = nn.Sequential(conv_bn_relu(2 * c, 2 * c),
                                           nn.Conv2d(2 * c, 2, 3, padding=1, bias=True))

    def train(self, mode=True):
        if mode:
            raise NotImplementedError(A7B)
        return super().train(False)

    def forward(self, batch):
        if self.training:
            raise NotImplementedError(A7B)
        bev_img = self.conv_input(batch["spatial_features_2d"])
        corrected, cls_prob, flow3d = self.correct_points(batch, bev_img)
        out = dict(batch)
        out["spatial_features_2d"] = self.blend(bev_img, corrected)
        out["points_cls_prob"] = cls_prob
        out["points_flow3d"] = flow3d
        return out

    def correct_points(self, batch, bev_img):
        """Point head, dynamic points moved by their flow and sampled again,
        mean-scatter. Returns the corrected BEV (B, C, H, W), the class
        probabilities and the flow, each (B, N, 3)."""
        points, pmask = batch["points"], batch["points_mask"]
        b, c, h, w = bev_img.shape
        n = points.shape[1]
        img = bev_img.permute(0, 2, 3, 1).contiguous()
        xy = points[..., 0:2]
        points_feat, _ = bilinear_interpolate_bev(img, xy, self.pc_range, self.pixel_size)
        cls_logit, flow3d = self.point_head(points_feat.reshape(b * n, c), pmask.reshape(b * n))
        cls_prob = torch.sigmoid(cls_logit).reshape(b, n, 3)
        flow3d = flow3d.reshape(b, n, 3)

        max_prob, max_idx = torch.max(cls_prob, dim=-1)  # first index of the max, as jnp.argmax
        dyn = ((max_prob > self.thresh_point_cls_prob) & (max_idx == 2) & pmask)[..., None]
        moved_xy = torch.where(dyn, xy + flow3d[..., 0:2], xy)
        feat, coord = bilinear_interpolate_bev(img, moved_xy, self.pc_range, self.pixel_size)
        del img
        feat = torch.where(dyn, feat, points_feat)
        del points_feat
        corrected = bev_scatter(coord, feat, pmask, h, w)
        return corrected.permute(0, 3, 1, 2).contiguous(), cls_prob, flow3d

    def blend(self, bev_img, corrected):
        """The learned 2-way softmax weighting of the two images."""
        weights = torch.softmax(self.conv_weightor(torch.cat([bev_img, corrected], dim=1)), dim=1)
        return bev_img * weights[:, 0:1] + corrected * weights[:, 1:2]
