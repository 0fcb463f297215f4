"""PointRCNN's second stage: counterpart of
``pcp_tpu/models/roi_heads/pointrcnn_head.py``.

Proposal NMS over the point head's boxes (``NMS_CONFIG.TRAIN`` or ``TEST``),
in training the proposal target layer's ROI sampling, then per ROI its first
``NUM_SAMPLED_POINTS`` points (``ops/roipoint_pool3d.py``) with the point
score, the normalised depth and the backbone's features, turned into the
ROI's canonical frame; an xyz-up MLP on the five prefix channels, a
merge-down MLP, a chain of single-scale set abstractions ending in a group of
all, and the cls and reg towers. pcdet's names: ``xyz_up_layer``,
``merge_down_layer``, ``SA_modules``, ``cls_layers``, ``reg_layers`` (1x1
layers as ``Linear``).

The sampling priorities (``roi_head_template.sample_rois_for_rcnn``) are
drawn from ``self.generator`` (a CPU ``torch.Generator``, seed 0 until
:meth:`RoIHeadTemplate.reseed`), or taken from the batch's
``roi_sampling_priorities`` (B, 3, P) where it has them: the parity tests
hand in the JAX package's draws there.
"""
import torch

from ...ops.roipoint_pool3d import roipoint_pool3d
from ..backbones_3d.pointnet2_modules import PointnetSAModuleMSG, SharedMLP
from .roi_head_template import (RoIHeadTemplate, assign_targets, make_fc_layers, proposal_layer,
                                rotate_points_along_z)

NUM_PREFIX = 5  # xyz, point score, point depth


class PointRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, num_class, input_channels):
        super().__init__(model_cfg, num_class)
        use_bn = bool(model_cfg.get("USE_BN", False))
        up = [int(c) for c in model_cfg["XYZ_UP_LAYER"]]
        self.xyz_up_layer = SharedMLP([NUM_PREFIX] + up, use_bn=use_bn)
        c_out = up[-1]
        self.merge_down_layer = SharedMLP([c_out + input_channels, c_out], use_bn=use_bn)
        sa_cfg = model_cfg["SA_CONFIG"]
        self.SA_modules = torch.nn.ModuleList()
        channels = c_out
        for k, npoint in enumerate(sa_cfg["NPOINTS"]):
            sa = PointnetSAModuleMSG(
                npoint=None if int(npoint) == -1 else int(npoint),
                radii=[float(sa_cfg["RADIUS"][k])], nsamples=[int(sa_cfg["NSAMPLE"][k])],
                mlps=[list(sa_cfg["MLPS"][k])], in_channels=channels, use_bn=use_bn)
            self.SA_modules.append(sa)
            channels = sa.out_channels
        dp = float(model_cfg.get("DP_RATIO", 0.0))
        self.cls_layers = make_fc_layers(channels, model_cfg["CLS_FC"], num_class, dp)
        self.reg_layers = make_fc_layers(channels, model_cfg["REG_FC"],
                                         self.box_coder.code_size * num_class, dp)

    def forward(self, batch):
        out = proposal_layer(dict(batch), self.model_cfg["NMS_CONFIG"][
            "TRAIN" if self.training else "TEST"])
        targets = None
        if self.training:
            tcfg = self.model_cfg["TARGET_CONFIG"]
            targets = assign_targets(self.sampling_priorities(out, out["rois"].shape[1]), out,
                                     tcfg, bool(tcfg.get("SAMPLE_ROI_BY_EACH_CLASS", False)))
            out["rois"], out["roi_labels"] = targets["rois"], targets["roi_labels"]

        rois = out["rois"]
        b, r = rois.shape[:2]
        pool_cfg = self.model_cfg["ROI_POINT_POOL"]
        coords = out["point_coords"]
        depth = torch.linalg.norm(coords, dim=-1) / float(pool_cfg["DEPTH_NORMALIZER"]) - 0.5
        feats_all = torch.cat([out["point_cls_scores"].detach()[..., None], depth[..., None],
                               out["point_features"]], dim=-1)
        pooled, empty = roipoint_pool3d(
            coords, feats_all, rois, num_sampled_points=int(pool_cfg["NUM_SAMPLED_POINTS"]),
            pool_extra_width=pool_cfg["POOL_EXTRA_WIDTH"],
            points_mask=out.get("point_coords_mask"))
        s = pooled.shape[2]
        xyz = rotate_points_along_z(pooled[..., 0:3] - rois[:, :, None, 0:3], -rois[..., 6])
        pooled = torch.where(empty[..., None, None], 0.0,
                             torch.cat([xyz, pooled[..., 3:]], dim=-1))
        flat = pooled.reshape(b * r, s, -1)
        merged = self.merge_down_layer(torch.cat([self.xyz_up_layer(flat[..., :NUM_PREFIX]),
                                                  flat[..., NUM_PREFIX:]], dim=-1))
        l_xyz, l_feat, l_mask = flat[..., 0:3], merged, None
        for sa in self.SA_modules:
            l_xyz, l_feat, l_mask = sa(l_xyz, l_feat, mask=l_mask)
        shared = l_feat[:, 0]
        rcnn_cls = self.cls_layers(shared).reshape(b, r, -1)
        rcnn_reg = self.reg_layers(shared).reshape(b, r, -1)

        if self.training:
            out["roi_head_loss"], out["roi_head_tb"] = self.get_loss(
                dict(targets, rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg))
        else:
            out["batch_cls_preds"] = rcnn_cls
            out["batch_box_preds"] = self.generate_predicted_boxes(rois, rcnn_reg)
            out["batch_pred_valid"] = out["roi_valid"]
            out["cls_preds_normalized"] = False
        return out
