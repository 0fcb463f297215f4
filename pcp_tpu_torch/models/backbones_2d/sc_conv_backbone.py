"""Self-calibrated-convolution BEV backbones, the "pointpillar_jr" backbone.

Counterpart of ``pcp_tpu/models/backbones_2d/sc_conv_backbone.py``
(``SCConv``, ``SCBottleneck``, ``SCConvBackbone2dStride1`` and
``SCConvBackbone2dStride4``, after the reference's ``workspace/sc_conv.py``,
SCNet's blocks):

  stem  (3x3 conv, stride 1 or 2, + 3 SCBottlenecks)
  skip  (1x1 conv of the stem's output)
  main  (3x3 conv stride 2 + 3 SCBottlenecks + a 2x2 transposed conv back up)
  out   (3x3 conv over concat[main, skip], stride 1 or 2)

SCConv: k2 = avgpool(4) -> 3x3 conv -> BN, upsampled back by nearest
neighbour; attention = sigmoid(x + up(k2)); out = k4(k3(x) * attention).

Every BN has eps 1e-3 and flax's convention (``norm.BatchNorm2d``; flax
momentum 0.99 is torch momentum 0.01). The pooling floors, as flax's VALID
``avg_pool`` does. The upsampling is ``jax.image.resize(..., "nearest")``'s,
with half-pixel centres: source row ``floor((i + 0.5) * in / out)``, torch's
``"nearest-exact"`` at an explicit size (plain ``"nearest"`` takes
``floor(i * in / out)``, which differs where the grid is not a multiple of
16). The JAX package runs these backbones in float32 whatever ``MODEL.BF16``
says, and so does the port.

State-dict names follow SCNet's modules: an SCBottleneck holds ``conv1_a``,
``bn1_a``, ``conv1_b``, ``bn1_b``, ``k1.{0,1}`` (conv, BN), ``scconv`` and
``conv3``, ``bn3``; an SCConv ``k2.{1,2}`` (after the pool at ``k2.0``),
``k3.{0,1}``, ``k4.{0,1}``. The backbone's are ``stem.{0,1}`` (conv, BN) with
the bottlenecks at ``stem.{3,4,5}``, ``conv_skip.{0,1}``, ``main.{0,1}``
(the strided conv), ``main.{3,4,5}``, ``main.{6,7}`` (the transposed conv and
its BN) and ``conv_out.{0,1}``.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..model_utils.norm import BatchNorm2d

BN_EPS = 1e-3


def _bn(c):
    return BatchNorm2d(c, eps=BN_EPS, momentum=0.01)


def _conv_bn(c_in, c_out, kernel=3, stride=1, pad=0):
    return [nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=pad, bias=False), _bn(c_out)]


def _conv_bn_relu(c_in, c_out, kernel=3, stride=1, pad=0):
    return _conv_bn(c_in, c_out, kernel, stride, pad) + [nn.ReLU()]


class SCConv(nn.Module):
    def __init__(self, features, pooling_r=4):
        super().__init__()
        self.k2 = nn.Sequential(nn.AvgPool2d(pooling_r, pooling_r), *_conv_bn(features, features, 3, 1, 1))
        self.k3 = nn.Sequential(*_conv_bn(features, features, 3, 1, 1))
        self.k4 = nn.Sequential(*_conv_bn(features, features, 3, 1, 1))

    def forward(self, x):
        up = F.interpolate(self.k2(x), size=x.shape[2:], mode="nearest-exact")
        return self.k4(self.k3(x) * torch.sigmoid(x + up))


class SCBottleneck(nn.Module):
    """The backbone's use of SCNet's bottleneck: stride 1, no downsample,
    cardinality 1, bottleneck width 32, so each branch has planes / 2
    channels."""

    def __init__(self, planes):
        super().__init__()
        gw = int(planes * (32 / 64.0))
        self.conv1_a, self.bn1_a = _conv_bn(planes, gw, 1)
        self.conv1_b, self.bn1_b = _conv_bn(planes, gw, 1)
        self.k1 = nn.Sequential(*_conv_bn(gw, gw, 3, 1, 1))
        self.scconv = SCConv(gw)
        self.conv3, self.bn3 = _conv_bn(2 * gw, planes, 1)

    def forward(self, x):
        a = F.relu(self.k1(F.relu(self.bn1_a(self.conv1_a(x)))))
        b = F.relu(self.scconv(F.relu(self.bn1_b(self.conv1_b(x)))))
        return F.relu(self.bn3(self.conv3(torch.cat([a, b], 1))) + x)


class _SCConvBackbone(nn.Module):
    """stem -> skip and main -> out; ``stride`` is the stem's and the output
    conv's stride (1, or 2 for an output at 4x the input's stride)."""

    def __init__(self, input_channels, stem_ch, main_ch, out_ch, stride):
        super().__init__()
        self.stem = nn.Sequential(*_conv_bn_relu(input_channels, stem_ch, 3, stride, 1),
                                  *[SCBottleneck(stem_ch) for _ in range(3)])
        self.conv_skip = nn.Sequential(*_conv_bn_relu(stem_ch, main_ch, 1))
        self.main = nn.Sequential(*_conv_bn_relu(stem_ch, main_ch, 3, 2, 1),
                                  *[SCBottleneck(main_ch) for _ in range(3)],
                                  nn.ConvTranspose2d(main_ch, main_ch, 2, stride=2, bias=False),
                                  _bn(main_ch), nn.ReLU())
        self.conv_out = nn.Sequential(*_conv_bn_relu(2 * main_ch, out_ch, 3, stride, 1))
        self.num_bev_features = out_ch

    def forward(self, batch):
        s = self.stem(batch["spatial_features"])
        out = dict(batch)
        out["spatial_features_2d"] = self.conv_out(torch.cat([self.main(s), self.conv_skip(s)], 1))
        return out


class SCConvBackbone2dStride1(_SCConvBackbone):
    """Output at the input's stride; the stem has ``STEM_CHANNELS``, the
    main branch the input's width."""

    def __init__(self, model_cfg, input_channels, bf16=False):
        super().__init__(input_channels, int(model_cfg["STEM_CHANNELS"]), input_channels,
                         int(model_cfg["NUM_BEV_FEATURES"]), stride=1)


class SCConvBackbone2dStride4(_SCConvBackbone):
    """Output at 4x the input's stride (the stem and the output conv at
    stride 2); the stem has twice the input's width, the main branch four
    times."""

    def __init__(self, model_cfg, input_channels, bf16=False):
        super().__init__(input_channels, 2 * input_channels, 4 * input_channels,
                         int(model_cfg["NUM_BEV_FEATURES"]), stride=2)
