"""Sparse 3D voxel backbone of the SECOND family (VoxelResBackBone8x).

Counterpart of ``pcp_tpu/models/backbones_3d/spconv_backbone.py`` on the
fixed-budget engine of ``ops/sparse3d.py``:

    conv_input: subm3 C_in -> 16                  [z 41]
    conv1: 2 x SparseBasicBlock(16)               [z 41]
    conv2: spconv3 s2 16 -> 32, 2 x block         [z 21]
    conv3: spconv3 s2 32 -> 64, 2 x block         [z 11]
    conv4: spconv3 s2 p(0,1,1) 64 -> 128, 2 x block [z 5]
    conv_out: spconv (3,1,1) s(2,1,1) 128 -> 128  [z 2]

A level's neighbour map is built once and shared by its submanifold convs
(spconv's ``indice_key``); each strided conv keeps at most as many output
sites as the input budget V, the first in id order. Convs have no bias;
each is followed by a ``MaskedBatchNorm`` (eps 1e-3, torch momentum 0.01,
statistics over the valid voxels, the global batch's under several ranks)
and a ReLU, and the unused budget slots are held at 0. ``VoxelBackBone8x``
is the same network, as in the JAX package.

**Weights.** Modules and names are pcdet's (``conv_input.0.weight`` and its
BN ``conv_input.1``; ``conv1.0.conv1.weight``, ``conv1.0.bn1``,
``conv1.0.conv2.weight``, ``conv1.0.bn2``; ``conv2.0.0.weight`` and
``conv2.0.1`` for the strided conv, then ``conv2.1.conv1.weight``, ...;
``conv_out.0.weight``, ``conv_out.1``). A kernel is held in spconv 2.x's
layout, (Cout, kz, ky, kx, Cin), the layout pcdet's loader turns spconv 1.x
checkpoints into. The JAX package holds it as (K * Cin, Cout) with K in
``kernel_offsets`` order (z outer, then y, then x) for the submanifold and
the strided convs alike, that is spconv 1.x's (kz, ky, kx, Cin, Cout)
flattened; so the JAX kernel ``w`` maps to
``w.reshape(kz, ky, kx, Cin, Cout).transpose(4, 0, 1, 2, 3)``
(``utils/jax_weights.py``) and back by the inverse. UNetV2 waits for ROADMAP
A11.6.
"""
import torch
from torch import nn

from ...ops import sparse3d
from ..model_utils.norm import MaskedBatchNorm


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def out_dims(dims, kernel, stride, padding):
    """The output grid of a strided conv: (n + 2p - k) // s + 1 per axis."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    return tuple((dims[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1 for i in range(3))


class SparseConv3d(nn.Module):
    """A sparse conv's kernel, (Cout, kz, ky, kx, Cin); ``matrix`` gives it as
    the (K, Cin, Cout) stack that ``ops/sparse3d.py`` multiplies by. Built
    normal with std 1/sqrt(fan-in), the fan-in K * Cin
    (``train_state.init_weights`` draws the JAX package's initial values)."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.weight = nn.Parameter(torch.empty(out_channels, *self.kernel_size, in_channels))
        nn.init.normal_(self.weight, 0.0, self.weight[0].numel() ** -0.5)

    def matrix(self):
        cout, cin = self.weight.shape[0], self.weight.shape[-1]
        return self.weight.permute(1, 2, 3, 4, 0).reshape(-1, cin, cout)


def _norm_act(bn, x, valid, act=True):
    x = bn(x, valid)
    if act:
        x = torch.relu(x)
    return torch.where(valid[..., None], x, 0.0)


class SubMConvBlock(nn.Sequential):
    """``conv_input``: submanifold conv -> BN -> ReLU."""

    def __init__(self, in_channels, out_channels):
        super().__init__(SparseConv3d(in_channels, out_channels, 3),
                         MaskedBatchNorm(out_channels, eps=1e-3, momentum=0.01))

    def forward(self, feats, nmap, valid):
        return _norm_act(self[1], sparse3d.subm_conv_apply(feats, nmap, self[0].matrix()), valid)


class SparseBasicBlock(nn.Module):
    """Two submanifold convs with a residual: conv1 -> bn1 -> ReLU -> conv2
    -> bn2, + input, ReLU."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels, 3)
        self.bn1 = MaskedBatchNorm(channels, eps=1e-3, momentum=0.01)
        self.conv2 = SparseConv3d(channels, channels, 3)
        self.bn2 = MaskedBatchNorm(channels, eps=1e-3, momentum=0.01)

    def forward(self, feats, nmap, valid):
        x = _norm_act(self.bn1, sparse3d.subm_conv_apply(feats, nmap, self.conv1.matrix()), valid)
        x = _norm_act(self.bn2, sparse3d.subm_conv_apply(x, nmap, self.conv2.matrix()), valid,
                      act=False)
        return torch.where(valid[..., None], torch.relu(x + feats), 0.0)


class StridedConvBlock(nn.Sequential):
    """A strided sparse conv -> BN -> ReLU onto its compacted output sites."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2, padding=1):
        super().__init__(SparseConv3d(in_channels, out_channels, kernel_size),
                         MaskedBatchNorm(out_channels, eps=1e-3, momentum=0.01))
        self.stride, self.padding = stride, padding

    def forward(self, in_ids, feats, dims):
        """Returns (out_ids, features, valid, out_dims)."""
        conv = self[0]
        dims_out = out_dims(dims, conv.kernel_size, self.stride, self.padding)
        out_ids = sparse3d.strided_output_ids(in_ids, dims, dims_out, conv.kernel_size,
                                              self.stride, self.padding, budget=in_ids.shape[1])
        x = sparse3d.strided_conv_apply(in_ids, feats, out_ids, dims, dims_out, conv.kernel_size,
                                        self.stride, self.padding, conv.matrix())
        valid = out_ids < dims_out[0] * dims_out[1] * dims_out[2]
        return out_ids, _norm_act(self[1], x, valid), valid, dims_out


# (name, channels, kernel, stride, padding) of the strided levels
LEVELS = (("conv2", 32, 3, 2, 1), ("conv3", 64, 3, 2, 1), ("conv4", 128, 3, 2, (0, 1, 1)))


class VoxelResBackBone8x(nn.Module):
    def __init__(self, model_cfg, num_point_features, num_res_blocks=2):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = 128
        self.conv_input = SubMConvBlock(num_point_features, 16)
        self.conv1 = nn.ModuleList(SparseBasicBlock(16) for _ in range(num_res_blocks))
        cin = 16
        for name, ch, k, s, p in LEVELS:
            self.add_module(name, nn.ModuleList(
                [StridedConvBlock(cin, ch, k, s, p)]
                + [SparseBasicBlock(ch) for _ in range(num_res_blocks)]))
            cin = ch
        self.conv_out = StridedConvBlock(128, 128, (3, 1, 1), (2, 1, 1), 0)
        # the width of each level of multi_scale_3d_features
        self.level_channels = {"x_conv1": 16, **{f"x_{name}": ch for name, ch, *_ in LEVELS}}

    def forward(self, batch):
        ids, dims = batch["voxel_ids"], batch["sparse_dims"]
        offsets = sparse3d.kernel_offsets(3)
        nmap = sparse3d.neighbor_map_subm(ids, offsets, dims)
        valid = ids < dims[0] * dims[1] * dims[2]
        x = self.conv_input(batch["voxel_features"], nmap, valid)
        for block in self.conv1:
            x = block(x, nmap, valid)
        multi_scale = {"x_conv1": (ids, x, dims, 1)}
        for (name, *_), ds in zip(LEVELS, (2, 4, 8)):
            down, *blocks = getattr(self, name)
            ids, x, valid, dims = down(ids, x, dims)
            nmap = sparse3d.neighbor_map_subm(ids, offsets, dims)
            for block in blocks:
                x = block(x, nmap, valid)
            multi_scale[f"x_{name}"] = (ids, x, dims, ds)
        out_ids, x, _, dims_out = self.conv_out(ids, x, dims)
        out = dict(batch)
        out["encoded_spconv_tensor"] = (out_ids, x)
        out["encoded_spconv_dims"] = dims_out
        out["multi_scale_3d_features"] = multi_scale
        return out


# the non-residual variant shares the topology in the JAX package too
VoxelBackBone8x = VoxelResBackBone8x
