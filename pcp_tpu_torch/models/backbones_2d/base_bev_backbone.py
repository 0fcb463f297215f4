"""Multi-scale dense BEV backbone.

Counterpart of ``pcp_tpu/models/backbones_2d/base_bev_backbone.py``
(``BaseBEVBackbone``), laid out as pcdet lays it out so that state-dict names
match: ``blocks.{l}`` is ZeroPad2d(1), the level's first (strided) 3x3 conv,
BN, ReLU, then [3x3 conv, BN, ReLU] per extra layer, so conv k sits at index
3k+1 and its BN at 3k+2; ``deblocks.{l}`` is a transposed conv (upsample
stride >= 1) or a strided conv (stride < 1), BN, ReLU. Every BN has eps 1e-3
and flax's convention (``norm.BatchNorm2d``; flax momentum 0.99 is torch
momentum 0.01). Tensors are (B, C, H, W).

The JAX package's serving switches, each inference-time:

* ``FOLD_BN``: every BN is baked into the conv in front of it, which gains a
  bias; the BN's slot holds ``nn.Identity`` so that the indices stay pcdet's.
  Load a trained state dict through :func:`fold_bn_state_dict`.
* ``W_PACK``: levels of at most 64 filters and stride 1 or 2 run on a
  width-packed layout, (B, 2C, H, W/2) with channel blocks [w-even | w-odd]
  (:func:`pack_width`), with structured kernels (:func:`pack_kernel`) that
  reproduce the plain convs exactly. It is a layout for the TPU's matrix
  unit, carried over for exactness. Load through :func:`w_pack_state_dict`
  (after any fold). Training raises, as the JAX package asserts.
* ``BF16`` (or ``bf16=True``, from ``MODEL.BF16``): convs and BNs compute in
  bfloat16 as flax's ``dtype=bfloat16`` does (``model_utils/precision.py``,
  ``norm.BatchNorm2d``); parameters and statistics stay float32 and
  ``spatial_features_2d`` comes back float32. Serving only.
"""
import numpy as np
import torch
from torch import nn

from ..model_utils.norm import BatchNorm2d
from ..model_utils.precision import Conv2d, ConvTranspose2d

BN_EPS = 1e-3
# W_PACK's structured kernel: for the even and the odd output block, the
# (packed kernel's kw tap, parity of the packed input block, the plain
# kernel's kw tap) it copies (the JAX package's ``_pack_kernel``)
_EVEN_TAPS = ((0, 1, 0), (1, 0, 1), (1, 1, 2))
_ODD_TAPS = {False: ((1, 0, 0), (1, 1, 1), (2, 0, 2)),  # stride 1
             True: ((1, 1, 0), (2, 0, 1), (2, 1, 2))}  # stride 2


def wpack_levels(cfg):
    """Indices of the levels that ``W_PACK: True`` packs: at most 64 filters
    and stride 1 or 2."""
    if not cfg.get("W_PACK", False):
        return set()
    nf, st = list(cfg.get("NUM_FILTERS", [])), list(cfg.get("LAYER_STRIDES", []))
    return {i for i in range(len(nf)) if nf[i] <= 64 and st[i] in (1, 2)}


def pack_kernel(weight, strided):
    """A (Co, Ci, 3, 3) conv weight -> the (2Co, 2Ci, 3, 3) weight that
    computes the same conv on the width-packed layout; ``strided`` for the
    stride-2 first conv of a level. Zeros elsewhere make the extra taps
    inert."""
    co, ci, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"W_PACK packs 3x3 kernels, got {(kh, kw)}")
    packed = weight.new_zeros((2 * co, 2 * ci, 3, 3))
    for out_par, taps in ((0, _EVEN_TAPS), (1, _ODD_TAPS[bool(strided)])):
        for dst, in_par, src in taps:
            packed[out_par * co:(out_par + 1) * co, in_par * ci:(in_par + 1) * ci, :, dst] = \
                weight[:, :, :, src]
    return packed


def pack_width(x):
    """(B, C, H, W) -> (B, 2C, H, W/2), channels [w-even | w-odd]: the JAX
    package's free NHWC reshape (B, H, W, C) -> (B, H, W/2, 2C)."""
    b, c, h, w = x.shape
    if w % 2:
        raise ValueError(f"W_PACK needs an even width, got {w}")
    return x.reshape(b, c, h, w // 2, 2).permute(0, 4, 1, 2, 3).reshape(b, 2 * c, h, w // 2)


def unpack_width(x):
    """The inverse of :func:`pack_width`."""
    b, c2, h, wp = x.shape
    return x.reshape(b, 2, c2 // 2, h, wp).permute(0, 2, 3, 4, 1).reshape(b, c2 // 2, h, 2 * wp)


def _conv_bn_pairs(cfg, prefix):
    """(conv, BN, the conv weight's out-channel axis) key prefixes of every
    conv-BN pair of a backbone built from ``cfg``."""
    ups = list(cfg.get("UPSAMPLE_STRIDES", []))
    pairs = []
    for l, n in enumerate(list(cfg.get("LAYER_NUMS", []))):
        pairs += [(f"{prefix}blocks.{l}.{3 * k + 1}", f"{prefix}blocks.{l}.{3 * k + 2}", 0)
                  for k in range(n + 1)]
        if ups:  # a transposed conv's weight is (in, out, kh, kw)
            pairs.append((f"{prefix}deblocks.{l}.0", f"{prefix}deblocks.{l}.1",
                          1 if ups[l] >= 1 else 0))
    return pairs


@torch.no_grad()
def fold_bn_state_dict(state_dict, cfg, prefix="backbone_2d."):
    """Counterpart of ``fold_bn_variables``: a state dict of the backbone
    built from ``cfg`` (under ``prefix``) with every BN baked into the conv
    in front of it, for the same backbone built with ``FOLD_BN: True``. The
    weight is scaled by gamma / sqrt(var + eps) on its out-channel axis and
    the conv's bias is beta - mean * scale. Other keys pass through."""
    sd = dict(state_dict)
    for conv, bn, out_axis in _conv_bn_pairs(cfg, prefix):
        scale = sd.pop(f"{bn}.weight") / torch.sqrt(sd.pop(f"{bn}.running_var") + BN_EPS)
        shape = [1, 1, 1, 1]
        shape[out_axis] = -1
        sd[f"{conv}.weight"] = sd[f"{conv}.weight"] * scale.reshape(shape)
        sd[f"{conv}.bias"] = sd.pop(f"{bn}.bias") - sd.pop(f"{bn}.running_mean") * scale
        sd.pop(f"{bn}.num_batches_tracked", None)
    return sd


@torch.no_grad()
def w_pack_state_dict(state_dict, cfg, prefix="backbone_2d."):
    """Counterpart of ``w_pack_variables``: a state dict of the backbone
    built from ``cfg`` without ``W_PACK`` (folded or not) for the same
    backbone with ``W_PACK: True``. The packed levels' kernels become
    structured (:func:`pack_kernel`); their BN parameters and statistics,
    or folded biases, tile x2."""
    sd = dict(state_dict)
    layer_nums, strides = list(cfg.get("LAYER_NUMS", [])), list(cfg.get("LAYER_STRIDES", []))
    for l in wpack_levels(cfg):
        for k in range(layer_nums[l] + 1):
            conv, bn = f"{prefix}blocks.{l}.{3 * k + 1}", f"{prefix}blocks.{l}.{3 * k + 2}"
            sd[f"{conv}.weight"] = pack_kernel(sd[f"{conv}.weight"],
                                               strided=k == 0 and strides[l] == 2)
            for key in (f"{conv}.bias", f"{bn}.weight", f"{bn}.bias", f"{bn}.running_mean",
                        f"{bn}.running_var"):
                if key in sd:
                    sd[key] = torch.cat([sd[key], sd[key]])
    return sd


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels, bf16=False):
        super().__init__()
        self.dtype = torch.bfloat16 if (bf16 or model_cfg.get("BF16", False)) else None
        folded = bool(model_cfg.get("FOLD_BN", False))
        self.packed_levels = wpack_levels(model_cfg)
        layer_nums = list(model_cfg.get("LAYER_NUMS", []))
        layer_strides = list(model_cfg.get("LAYER_STRIDES", []))
        num_filters = list(model_cfg.get("NUM_FILTERS", []))
        upsample_strides = list(model_cfg.get("UPSAMPLE_STRIDES", []))
        num_upsample_filters = list(model_cfg.get("NUM_UPSAMPLE_FILTERS", []))
        if len(upsample_strides) > len(layer_nums):
            raise NotImplementedError("BACKBONE_2D extra deblock is not ported yet (ROADMAP A11)")

        def norm(c):
            return nn.Identity() if folded else BatchNorm2d(c, eps=BN_EPS, momentum=0.01,
                                                            compute_dtype=self.dtype)

        c_in = [input_channels] + num_filters[:-1]
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        for idx in range(len(layer_nums)):
            mult = 2 if idx in self.packed_levels else 1
            ci, f = c_in[idx] * mult, num_filters[idx] * mult
            layers = [nn.ZeroPad2d(1),
                      Conv2d(ci, f, 3, stride=layer_strides[idx], bias=folded,
                             compute_dtype=self.dtype),
                      norm(f), nn.ReLU()]
            for _ in range(layer_nums[idx]):
                layers += [Conv2d(f, f, 3, padding=1, bias=folded, compute_dtype=self.dtype),
                           norm(f), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            if upsample_strides:
                s, up, f = upsample_strides[idx], num_upsample_filters[idx], num_filters[idx]
                if s >= 1:
                    conv = ConvTranspose2d(f, up, int(s), stride=int(s), bias=folded,
                                           compute_dtype=self.dtype)
                else:
                    k = int(np.round(1 / s))
                    conv = Conv2d(f, up, k, stride=k, bias=folded, compute_dtype=self.dtype)
                self.deblocks.append(nn.Sequential(conv, norm(up), nn.ReLU()))
        self.num_bev_features = (sum(num_upsample_filters) if num_upsample_filters
                                 else (num_filters[-1] if num_filters else input_channels))

    def forward(self, batch):
        if self.training and self.dtype is not None:
            raise NotImplementedError("BF16 training is not ported yet (ROADMAP A13b)")
        if self.training and self.packed_levels:
            raise RuntimeError("W_PACK is inference-only (BN statistics are per channel)")
        x = batch["spatial_features"]
        ups = []
        for i, block in enumerate(self.blocks):
            if i in self.packed_levels:
                x = unpack_width(block(pack_width(x)))
            else:
                x = block(x)
            ups.append(self.deblocks[i](x) if len(self.deblocks) else x)
        out = dict(batch)
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        out["spatial_features_2d"] = x if self.dtype is None else x.float()
        return out
