"""The point heads: counterpart of ``_PointHeadBase``, ``PointHeadBox``
(PointRCNN's first stage) and ``PointHeadSimple`` (PV-RCNN's keypoint
scores) in ``pcp_tpu/models/dense_heads/point_head.py``.

Per point, class logits and ``PointResidualCoder`` box residuals from two
FC towers (pcdet's ``cls_layers`` and ``box_layers``: [Linear without bias,
BN over the valid points, ReLU] per width, then a biased Linear). Targets:
a valid point inside a gt box (the first, by ``ops/points_in_boxes.py``) is
foreground, one inside only the box grown by ``GT_EXTRA_WIDTH`` is ignored;
losses are the sigmoid focal loss over foreground and background and the
smooth-L1 of the residuals over the foreground, each normalised by the
foreground count. In eval mode (and in training where an ROI head follows)
it decodes a box per point for the proposal layer. ``PointHeadSimple`` has
the class tower alone, over the VSA's keypoint features (those before the
fusion under ``USE_POINT_FEATURES_BEFORE_FUSION``), the same targets without
box labels and the focal loss alone; its ``point_cls_scores`` weigh the
keypoints in the ROI head. ``CLASS_AGNOSTIC`` makes a head one class.
``PointIntraPartOffsetHead`` waits for PartA2 (ROADMAP A11.6).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.points_in_boxes import first_box, points_in_boxes_mask
from ...utils.box_coder_utils import PointResidualCoder
from ..loss_fnc.anchor_losses import sigmoid_focal_cls_loss, weighted_smooth_l1
from ..model_utils.norm import MaskedBatchNorm


def enlarge_box3d(boxes, extra_width):
    """(..., 7+) with dx, dy, dz grown by ``extra_width``."""
    grown = boxes[..., 3:6] + torch.as_tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([boxes[..., :3], grown, boxes[..., 6:]], dim=-1)


class FCTower(nn.Sequential):
    """[Linear without bias, masked BN, ReLU] per width, then a biased
    Linear to ``out_channels``."""

    def __init__(self, in_channels, fc_cfg, out_channels):
        layers, c = [], in_channels
        for width in fc_cfg:
            layers += [nn.Linear(c, int(width), bias=False),
                       MaskedBatchNorm(int(width), eps=1e-5, momentum=0.1), nn.ReLU()]
            c = int(width)
        layers.append(nn.Linear(c, out_channels))
        super().__init__(*layers)

    def forward(self, x, mask=None):
        for layer in self:
            x = layer(x, mask) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x


def points_first_box(coords, boxes, boxes_valid):
    """(B, N) index of the first valid box of (B, M, 7) holding each point,
    -1 where none."""
    return first_box(points_in_boxes_mask(coords, boxes) & boxes_valid[:, None, :])


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, predict_boxes_when_training=False):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.cls_layers = FCTower(input_channels, model_cfg["CLS_FC"], num_class)

    def stack_targets(self, coords, mask, gt_boxes):
        """coords (B, N, 3), mask (B, N), gt_boxes (B, M, 8) zero-padded with
        the 1-based class last -> point_cls_labels (B, N) (-1 ignored: inside
        only the box grown by ``GT_EXTRA_WIDTH``), the foreground (B, N), and
        each point's gt box (B, N, 8)."""
        gt_valid = torch.any(gt_boxes != 0, dim=-1)
        box_idx = points_first_box(coords, gt_boxes[..., :7], gt_valid)
        fg = (box_idx >= 0) & mask
        gt_of_pts = torch.gather(gt_boxes, 1, box_idx.clamp(min=0)[..., None].expand(
            -1, -1, gt_boxes.shape[-1]))
        extend = enlarge_box3d(gt_boxes, self.model_cfg["TARGET_CONFIG"]["GT_EXTRA_WIDTH"])
        ext_idx = points_first_box(coords, extend[..., :7], gt_valid)
        ignore = fg ^ ((ext_idx >= 0) & mask)
        cls_of_fg = gt_of_pts[..., -1].to(torch.int64)
        labels = torch.where(fg, 1 if self.num_class == 1 else cls_of_fg, 0)
        labels = torch.where(mask, torch.where(ignore, -1, labels), 0)
        return labels, fg, gt_of_pts

    def get_cls_layer_loss(self, labels, cls_preds, mask):
        """The sigmoid focal loss over the foreground and the background,
        normalised by the foreground count -> (loss, tb)."""
        positives = labels > 0
        negatives = (labels == 0) & mask
        pos = positives.to(cls_preds.dtype)
        pos_norm = torch.clamp(pos.sum(), min=1.0)
        cls_weights = (negatives.to(cls_preds.dtype) + pos) / pos_norm
        one_hot = F.one_hot(labels.clamp(min=0), self.num_class + 1)[..., 1:].to(cls_preds.dtype)
        cls_loss = sigmoid_focal_cls_loss(cls_preds, one_hot, cls_weights).sum()
        cls_loss = cls_loss * float(self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]["point_cls_weight"])
        return cls_loss, {"point_loss_cls": cls_loss, "point_pos_num": pos_norm}

    def forward(self, batch):
        out = dict(batch)
        feats = (out["point_features_before_fusion"]
                 if self.model_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION", False)
                 else out["point_features"])
        mask = out["point_coords_mask"]
        cls_preds = self.cls_layers(feats, mask)
        out["point_cls_preds"] = cls_preds
        out["point_cls_scores"] = torch.sigmoid(cls_preds.max(dim=-1).values)
        if self.training:
            labels, _, _ = self.stack_targets(out["point_coords"], mask, out["gt_boxes"])
            out["point_head_loss"], out["point_head_tb"] = self.get_cls_layer_loss(
                labels, cls_preds, mask)
        return out


class PointHeadBox(PointHeadSimple):
    def __init__(self, model_cfg, input_channels, num_class, predict_boxes_when_training=False):
        super().__init__(model_cfg, input_channels, num_class)
        self.predict_boxes_when_training = predict_boxes_when_training
        coder_cfg = model_cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"]
        self.box_coder = PointResidualCoder(**{k.lower(): v for k, v in coder_cfg.items()})
        self.box_layers = FCTower(input_channels, model_cfg["REG_FC"], self.box_coder.code_size)

    def assign_targets(self, coords, mask, gt_boxes):
        """:meth:`stack_targets`' point_cls_labels and point_box_labels (B,
        N, code_size)."""
        labels, fg, gt_of_pts = self.stack_targets(coords, mask, gt_boxes)
        enc = self.box_coder.encode(gt_of_pts[..., :-1], coords, gt_of_pts[..., -1].to(torch.int64))
        return labels, torch.where(fg[..., None], enc, 0.0)

    def get_loss(self, labels, box_labels, cls_preds, box_preds, mask):
        cls_loss, tb = self.get_cls_layer_loss(labels, cls_preds, mask)
        pos = (labels > 0).to(cls_preds.dtype)
        box_loss = weighted_smooth_l1(box_preds, box_labels, weights=pos / tb["point_pos_num"]).sum()
        box_loss = box_loss * float(self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]["point_box_weight"])
        tb["point_loss_box"] = box_loss
        return cls_loss + box_loss, tb

    def forward(self, batch):
        out = dict(batch)
        feats, mask, coords = out["point_features"], out["point_coords_mask"], out["point_coords"]
        cls_preds = self.cls_layers(feats, mask)
        box_preds = self.box_layers(feats, mask)
        out["point_cls_preds"] = cls_preds
        out["point_cls_scores"] = torch.sigmoid(cls_preds.max(dim=-1).values)
        if self.training:
            labels, box_labels = self.assign_targets(coords, mask, out["gt_boxes"])
            out["point_head_loss"], out["point_head_tb"] = self.get_loss(
                labels, box_labels, cls_preds, box_preds, mask)
        if not self.training or self.predict_boxes_when_training:
            pred_classes = torch.argmax(cls_preds, dim=-1) + 1
            out["batch_cls_preds"] = cls_preds
            out["batch_box_preds"] = self.box_coder.decode(box_preds, coords, pred_classes)
            out["batch_pred_valid"] = mask
            out["cls_preds_normalized"] = False
        return out


POINT_HEADS = {"PointHeadSimple": PointHeadSimple, "PointHeadBox": PointHeadBox}


def build_point_head(cfg, input_channels, num_class, predict_boxes_when_training=False):
    if cfg["NAME"] not in POINT_HEADS:
        raise NotImplementedError(f"POINT_HEAD {cfg['NAME']!r} is not ported yet (ROADMAP A11.6)")
    if bool(cfg.get("CLASS_AGNOSTIC", False)):
        num_class = 1
    return POINT_HEADS[cfg["NAME"]](cfg, input_channels, num_class,
                                    predict_boxes_when_training=predict_boxes_when_training)
