"""PV-RCNN's second stage: counterpart of
``pcp_tpu/models/roi_heads/pvrcnn_head.py``.

Proposal NMS over the anchor head's boxes (``NMS_CONFIG.TRAIN`` or
``TEST``), in training the proposal target layer's ROI sampling, then ROI
grid pooling: a ``GRID_SIZE``^3 lattice of points in each ROI
(:func:`get_dense_grid_points`, turned by the ROI's heading and moved to its
centre) gathers the keypoint features, each weighted by its (detached)
``point_cls_scores``, through a multi-scale set abstraction
(``PointnetSAModuleMSG`` with the grid points as ``new_xyz``). The pooled
grid, flattened channel-major (C, G, G, G) as pcdet's ``view`` of the
``(B*R, C, G, G, G)`` tensor, goes through the shared FC layers and the cls
and reg towers. pcdet's names: ``roi_grid_pool_layer``, ``shared_fc_layer``
([Linear without bias, BN, ReLU] per width, a Dropout after the first when
``DP_RATIO`` > 0, as the JAX package's ``fc_stack``), ``cls_layers``,
``reg_layers`` (1x1 layers as ``Linear``). The JAX package flattens the
grid grid-major (G^3 x C): ``utils/jax_weights.py`` permutes the first
shared layer's input columns.

The sampling priorities come from ``self.generator`` or the batch's
``roi_sampling_priorities``, as in ``pointrcnn_head.py``. PV-RCNN++: an
``ROI_GRID_POOL`` named ``VectorPoolAggregationModuleMSG`` pools the grid
through VectorPool (``backbones_3d/vector_pool.py``), and targets handed in
as ``roi_targets_dict`` (sampled by the detector before the PFE) are used
as they are.
"""
import numpy as np
import torch
from torch import nn

from ..backbones_3d.pointnet2_modules import PointnetSAModuleMSG
from ..backbones_3d.vector_pool import VectorPoolAggregationModuleMSG
from ..model_utils.norm import MaskedBatchNorm
from .roi_head_template import (RoIHeadTemplate, assign_targets, make_fc_layers, proposal_layer,
                                rotate_points_along_z)


def get_dense_grid_points(rois, grid_size):
    """rois (..., 7+) -> each ROI's lattice offsets (..., G^3, 3) about its
    centre, the C-order lattice of ``np.nonzero`` (x outer): ``(index +
    0.5) / G * size - size / 2`` in the JAX package's order, each operation
    rounded (as its op-by-op run; its jitted CPU code fuses some of the
    multiply-adds, which way depends on how XLA vectorises the loop)."""
    g = int(grid_size)
    idx = torch.from_numpy(np.stack(np.nonzero(np.ones((g, g, g))), axis=-1).astype(np.float32))
    frac = (idx + 0.5) / torch.tensor(float(g))
    size = rois[..., None, 3:6]
    return frac.to(rois.device, rois.dtype) * size - size / 2


class PVRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, num_class, input_channels):
        super().__init__(model_cfg, num_class)
        pool_cfg = model_cfg["ROI_GRID_POOL"]
        self.grid_size = int(pool_cfg["GRID_SIZE"])
        if pool_cfg.get("NAME") == "VectorPoolAggregationModuleMSG":
            self.roi_grid_pool_layer = VectorPoolAggregationModuleMSG(int(input_channels),
                                                                      pool_cfg)
        else:
            if pool_cfg.get("POOL_METHOD", "max_pool") != "max_pool":
                raise NotImplementedError(f"POOL_METHOD {pool_cfg['POOL_METHOD']!r}")
            self.roi_grid_pool_layer = PointnetSAModuleMSG(
                npoint=1, radii=[float(r) for r in pool_cfg["POOL_RADIUS"]],
                nsamples=[int(n) for n in pool_cfg["NSAMPLE"]],
                mlps=[list(m) for m in pool_cfg["MLPS"]], in_channels=int(input_channels))
        dp = float(model_cfg.get("DP_RATIO", 0.0))
        layers, c = [], self.grid_size ** 3 * self.roi_grid_pool_layer.out_channels
        for k, width in enumerate(model_cfg["SHARED_FC"]):
            layers += [nn.Linear(c, int(width), bias=False),
                       MaskedBatchNorm(int(width), eps=1e-5, momentum=0.1), nn.ReLU()]
            c = int(width)
            if dp > 0 and k == 0:
                layers.append(nn.Dropout(dp))
        self.shared_fc_layer = nn.Sequential(*layers)
        self.cls_layers = make_fc_layers(c, model_cfg["CLS_FC"], num_class, dp)
        self.reg_layers = make_fc_layers(c, model_cfg["REG_FC"],
                                         self.box_coder.code_size * num_class, dp)

    def sample_targets(self, batch):
        """The proposal target layer: the sampled ROIs and their targets."""
        tcfg = self.model_cfg["TARGET_CONFIG"]
        return assign_targets(self.sampling_priorities(batch, batch["rois"].shape[1]), batch,
                              tcfg, bool(tcfg.get("SAMPLE_ROI_BY_EACH_CLASS", False)))

    def roi_grid_points(self, rois):
        """(B, R, 7+) ROIs -> their lattice points in the lidar frame
        (B, R * G^3, 3)."""
        b, r = rois.shape[:2]
        g3 = self.grid_size ** 3
        local = get_dense_grid_points(rois, self.grid_size).reshape(b * r, g3, 3)
        turned = rotate_points_along_z(local, rois[..., 6].reshape(b * r))
        return (turned.reshape(b, r, g3, 3) + rois[..., None, 0:3]).reshape(b, r * g3, 3)

    def forward(self, batch):
        out = proposal_layer(dict(batch), self.model_cfg["NMS_CONFIG"][
            "TRAIN" if self.training else "TEST"])
        targets = None
        if self.training:
            # PV-RCNN++ samples its targets before the PFE
            targets = out.get("roi_targets_dict") or self.sample_targets(out)
            out["rois"], out["roi_labels"] = targets["rois"], targets["roi_labels"]

        rois = out["rois"]
        b, r = rois.shape[:2]
        kp_feats = out["point_features"] * out["point_cls_scores"].detach()[..., None]
        grid = self.roi_grid_points(rois)
        if isinstance(self.roi_grid_pool_layer, VectorPoolAggregationModuleMSG):
            pooled = self.roi_grid_pool_layer(
                out["point_coords"], kp_feats, out["point_coords_mask"], grid,
                torch.ones(grid.shape[:2], dtype=torch.bool, device=grid.device))
        else:
            _, pooled, _ = self.roi_grid_pool_layer(out["point_coords"], kp_feats,
                                                    mask=out.get("point_coords_mask"),
                                                    new_xyz=grid)
        # pcdet's channel-major flattening of each ROI's (G^3, C) grid
        pooled = pooled.reshape(b * r, self.grid_size ** 3, -1).transpose(1, 2).reshape(b * r, -1)
        shared = self.shared_fc_layer(pooled)
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
