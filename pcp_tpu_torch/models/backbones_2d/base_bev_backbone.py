"""Multi-scale dense BEV backbone.

Counterpart of ``pcp_tpu/models/backbones_2d/base_bev_backbone.py``
(``BaseBEVBackbone``), laid out as pcdet lays it out so that state-dict names
match: ``blocks.{l}`` is ZeroPad2d(1), the level's first (strided) 3x3 conv,
BN, ReLU, then [3x3 conv, BN, ReLU] per extra layer, so conv k sits at index
3k+1 and its BN at 3k+2; ``deblocks.{l}`` is a transposed conv (upsample
stride >= 1) or a strided conv (stride < 1), BN, ReLU. Every BN has eps 1e-3
and flax's convention (``norm.BatchNorm2d``; flax momentum 0.99 is torch
momentum 0.01). Tensors are (B, C, H, W).
"""
import numpy as np
import torch
from torch import nn

from ..model_utils.norm import BatchNorm2d


# serving options of the JAX package that the port does not have yet
NOT_PORTED = {"FOLD_BN": "ROADMAP A12", "W_PACK": "ROADMAP A12", "BF16": "ROADMAP A13"}


def _bn(c):
    return BatchNorm2d(c, eps=1e-3, momentum=0.01)


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        for key, item in NOT_PORTED.items():
            if model_cfg.get(key, False):
                raise NotImplementedError(f"BACKBONE_2D {key} is not ported yet ({item})")
        layer_nums = list(model_cfg.get("LAYER_NUMS", []))
        layer_strides = list(model_cfg.get("LAYER_STRIDES", []))
        num_filters = list(model_cfg.get("NUM_FILTERS", []))
        upsample_strides = list(model_cfg.get("UPSAMPLE_STRIDES", []))
        num_upsample_filters = list(model_cfg.get("NUM_UPSAMPLE_FILTERS", []))
        if len(upsample_strides) > len(layer_nums):
            raise NotImplementedError("BACKBONE_2D extra deblock is not ported yet (ROADMAP A11)")

        c_in = [input_channels] + num_filters[:-1]
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        for idx in range(len(layer_nums)):
            f = num_filters[idx]
            layers = [nn.ZeroPad2d(1),
                      nn.Conv2d(c_in[idx], f, 3, stride=layer_strides[idx], bias=False),
                      _bn(f), nn.ReLU()]
            for _ in range(layer_nums[idx]):
                layers += [nn.Conv2d(f, f, 3, padding=1, bias=False), _bn(f), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            if upsample_strides:
                s, up = upsample_strides[idx], num_upsample_filters[idx]
                if s >= 1:
                    conv = nn.ConvTranspose2d(f, up, int(s), stride=int(s), bias=False)
                else:
                    k = int(np.round(1 / s))
                    conv = nn.Conv2d(f, up, k, stride=k, bias=False)
                self.deblocks.append(nn.Sequential(conv, _bn(up), nn.ReLU()))
        self.num_bev_features = (sum(num_upsample_filters) if num_upsample_filters
                                 else (num_filters[-1] if num_filters else input_channels))

    def forward(self, batch):
        x = batch["spatial_features"]
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            ups.append(self.deblocks[i](x) if len(self.deblocks) else x)
        out = dict(batch)
        out["spatial_features_2d"] = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return out
