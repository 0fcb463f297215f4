"""HeightCompression: the sparse 3D tensor as a dense BEV image.

Counterpart of ``pcp_tpu/models/map_to_bev/height_compression.py``: the
backbone's output sites are written into a dense (B, nz, ny, nx, C) grid and
z is folded into the channels, channel ``c * nz + z`` (pcdet's
``view(N, C * D, H, W)``). The image is handed on as (B, C * nz, ny, nx), a
permuted view of a (B, ny, nx, C * nz) grid as ``PointPillarScatter`` hands
on its BEV, so that the convolutions downstream read it channels-last, with
the feature stride 8; its width must equal ``NUM_BEV_FEATURES``.
"""
from torch import nn

from ...ops.sparse3d import sparse_to_dense


class HeightCompression(nn.Module):
    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.num_bev_features = int(model_cfg["NUM_BEV_FEATURES"])

    def forward(self, batch):
        ids, feats = batch["encoded_spconv_tensor"]
        nz, ny, nx = batch["encoded_spconv_dims"]
        dense = sparse_to_dense(ids, feats, (nz, ny, nx))  # (B, nz, ny, nx, C)
        b = dense.shape[0]
        bev = dense.permute(0, 2, 3, 4, 1).reshape(b, ny, nx, -1).permute(0, 3, 1, 2)
        if bev.shape[1] != self.num_bev_features:
            raise ValueError(f"HeightCompression gives {bev.shape[1]} channels, NUM_BEV_FEATURES "
                             f"is {self.num_bev_features}")
        out = dict(batch)
        out["spatial_features"] = bev
        out["spatial_features_stride"] = 8
        return out
