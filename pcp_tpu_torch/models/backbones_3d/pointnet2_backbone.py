"""PointNet2MSG, PointRCNN's point backbone: counterpart of
``pcp_tpu/models/backbones_3d/pointnet2_backbone.py``.

Set-abstraction levels downsample the padded cloud (B, N, 3 + C) by FPS to
``SA_CONFIG.NPOINTS``; feature-propagation levels carry the features back up
to every input point. Emits ``point_features`` (B, N, FP_MLPS[0][-1]),
``point_coords`` (B, N, 3) and ``point_coords_mask`` (B, N). pcdet's names:
``SA_modules.{k}``, ``FP_modules.{k}``.
"""
from torch import nn

from .pointnet2_modules import PointnetFPModule, PointnetSAModuleMSG


class PointNet2MSG(nn.Module):
    def __init__(self, model_cfg, num_point_features):
        super().__init__()
        sa_cfg = model_cfg["SA_CONFIG"]
        self.SA_modules = nn.ModuleList()
        channels = [num_point_features - 3]  # each level's feature width
        for k, npoint in enumerate(sa_cfg["NPOINTS"]):
            sa = PointnetSAModuleMSG(
                npoint=int(npoint), radii=[float(r) for r in sa_cfg["RADIUS"][k]],
                nsamples=[int(s) for s in sa_cfg["NSAMPLE"][k]],
                mlps=[list(m) for m in sa_cfg["MLPS"][k]], in_channels=channels[-1],
                use_xyz=bool(sa_cfg.get("USE_XYZ", True)))
            self.SA_modules.append(sa)
            channels.append(sa.out_channels)
        fp_mlps = [list(m) for m in model_cfg["FP_MLPS"]]
        widths = list(channels)  # each level's width once propagated
        fp_in = [0] * len(fp_mlps)
        for i in range(len(fp_mlps) - 1, -1, -1):
            fp_in[i] = widths[i + 1] + widths[i]
            widths[i] = fp_mlps[i][-1]
        self.FP_modules = nn.ModuleList(PointnetFPModule([fp_in[i]] + fp_mlps[i])
                                        for i in range(len(fp_mlps)))
        self.num_point_features = fp_mlps[0][-1]

    def forward(self, batch):
        out = dict(batch)
        points, mask = out["points"], out["points_mask"]
        xyz = points[..., 0:3]
        l_xyz, l_feat, l_mask = [xyz], [points[..., 3:] if points.shape[-1] > 3 else None], [mask]
        for sa in self.SA_modules:
            nx, nf, nm = sa(l_xyz[-1], l_feat[-1], mask=l_mask[-1])
            l_xyz.append(nx)
            l_feat.append(nf)
            l_mask.append(nm)
        for i in range(len(self.FP_modules) - 1, -1, -1):
            l_feat[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1], l_feat[i], l_feat[i + 1],
                                           unknown_mask=l_mask[i], known_mask=l_mask[i + 1])
        out["point_features"] = l_feat[0]
        out["point_coords"] = xyz
        out["point_coords_mask"] = mask
        return out
