"""Anchor-based dense head (AnchorHeadSingle).

Counterpart of ``pcp_tpu/models/dense_heads/anchor_head_single.py`` (pcdet's
``AnchorGenerator``, ``AxisAlignedTargetAssigner``, ``AnchorHeadTemplate``
and ``AnchorHeadSingle``):

* the anchors are made once in numpy float32 by the JAX package's
  arithmetic (:func:`generate_anchors`) and held as a buffer, (gy, gx,
  A_loc, 7) flattened in (gy, gx, A_loc) order;
* the axis-aligned assigner runs over the whole batch at once: each
  anchor's IoU with every gt box of its class set (the rotation-snapped BEV
  boxes of :func:`boxes3d_nearest_bev_iou`), its first best gt, the
  forced match of each gt's best anchors (float equality with the gt's best
  overlap; gts whose best overlap is 0 are dropped), the matched and
  unmatched thresholds; padding gt rows (all zeros) never match;
* the losses: the sigmoid focal loss over the cared anchors and the
  sin-difference smooth-L1 over the positives, each normalised by the
  sample's positive count and divided by the batch size, and the direction
  bins' cross-entropy. Under a process group of more than one rank the
  batch size is the global batch's; every other normaliser is per sample;
* three 1x1 convs, pcdet's ``conv_cls``, ``conv_box`` and ``conv_dir_cls``;
  their (B, A*C, H, W) output is read channels-last, so that the anchors
  flatten as (gy, gx, A_loc) as in the JAX package;
* the decoded boxes in eval mode, and in training too where an ROI head
  follows (``predict_boxes_when_training``, PV-RCNN's proposals).

Each quotient that a floor reads (``limit_period``, the direction target)
divides by a float32 tensor, as the JAX package divides: on the card a
division by a Python number becomes a multiply by its reciprocal. The ATSS
assigner and ``AnchorHeadMulti`` are used only by the nuScenes configs
(ROADMAP A11.4); ``MODEL.BF16`` on this head waits for A11.1b.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.collective import all_reduce_sum
from ...utils.box_coder_utils import PreviousResidualDecoder, ResidualCoder
from ..loss_fnc.anchor_losses import (sigmoid_focal_cls_loss, weighted_cross_entropy,
                                      weighted_smooth_l1)

_BOX_CODERS = {"ResidualCoder": ResidualCoder, "PreviousResidualDecoder": PreviousResidualDecoder}


def limit_period(val, offset=0.5, period=np.pi):
    """``val - floor(val / period + offset) * period``, the quotient taken in
    float32 by a true division."""
    p = torch.tensor(float(period), dtype=val.dtype, device=val.device)
    return val - torch.floor(val / p + offset) * p


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range, anchor_ndim=7):
    """The JAX package's ``generate_anchors`` in numpy: (ny_f, nx_f, A_loc,
    anchor_ndim) float32, every class set's anchors of a location in (set,
    size, rotation) order, and the anchors a location of each set."""
    per_set, num_per_loc, fmap = [], [], None
    for cfg in anchor_generator_cfg:
        stride = int(cfg["feature_map_stride"])
        gx, gy = int(grid_size[0]) // stride, int(grid_size[1]) // stride
        fmap = fmap or (gx, gy)
        if fmap != (gx, gy):
            raise ValueError("anchor sets must share a feature map size")
        sizes = np.asarray(cfg["anchor_sizes"], dtype=np.float32)
        rots = np.asarray(cfg["anchor_rotations"], dtype=np.float32)
        heights = np.asarray(cfg["anchor_bottom_heights"], dtype=np.float32)
        ns, nr, nz = len(sizes), len(rots), len(heights)
        if nz != 1:
            raise ValueError("one anchor_bottom_heights value a set is supported")
        num_per_loc.append(ns * nr * nz)
        if bool(cfg.get("align_center", False)):
            x_stride = (point_cloud_range[3] - point_cloud_range[0]) / gx
            y_stride = (point_cloud_range[4] - point_cloud_range[1]) / gy
            x_off, y_off = x_stride / 2, y_stride / 2
        else:
            x_stride = (point_cloud_range[3] - point_cloud_range[0]) / (gx - 1)
            y_stride = (point_cloud_range[4] - point_cloud_range[1]) / (gy - 1)
            x_off, y_off = 0.0, 0.0
        x_shifts = np.arange(point_cloud_range[0] + x_off, point_cloud_range[3] + 1e-5, x_stride,
                             dtype=np.float32)[:gx]
        y_shifts = np.arange(point_cloud_range[1] + y_off, point_cloud_range[4] + 1e-5, y_stride,
                             dtype=np.float32)[:gy]
        xx, yy, zz = np.meshgrid(x_shifts, y_shifts, heights, indexing="ij")
        centers = np.stack([xx, yy, zz], axis=-1)
        a = np.broadcast_to(centers[:, :, :, None, None, :], (gx, gy, nz, ns, nr, 3))
        sz = np.broadcast_to(sizes[None, None, None, :, None, :], (gx, gy, nz, ns, nr, 3))
        rr = np.broadcast_to(rots[None, None, None, None, :, None], (gx, gy, nz, ns, nr, 1))
        anchors = np.concatenate([a, sz, rr], axis=-1).transpose(2, 1, 0, 3, 4, 5).copy()
        anchors[..., 2] += anchors[..., 5] / 2  # bottom -> centre z
        per_set.append(anchors.reshape(gy, gx, ns * nr, 7))
    out = np.concatenate(per_set, axis=2)
    if anchor_ndim != 7:
        out = np.concatenate([out, np.zeros((*out.shape[:-1], anchor_ndim - 7), np.float32)], -1)
    return out.astype(np.float32), num_per_loc


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned IoU of the rotation-snapped BEV boxes: (..., N, 7) and
    (..., M, 7) -> (..., N, M)."""
    def aligned(boxes):
        rot = torch.abs(limit_period(boxes[..., 6], offset=0.5, period=np.pi))
        swap = (rot >= np.pi / 4)[..., None]
        dims = torch.where(swap, boxes[..., [4, 3]], boxes[..., [3, 4]])
        return torch.cat([boxes[..., 0:2] - dims / 2, boxes[..., 0:2] + dims / 2], dim=-1)

    a = aligned(boxes_a)[..., :, None, :]
    b = aligned(boxes_b)[..., None, :, :]
    ix = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    iy = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def add_sin_difference(boxes1, boxes2, dim=6):
    """sin(a - b) of the heading residual, as ``sin a cos b`` and
    ``cos a sin b`` in place of the two headings."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, bf16=False, predict_boxes_when_training=False):
        super().__init__()
        if bf16 or model_cfg.get("BF16", False):
            raise NotImplementedError("MODEL.BF16 on AnchorHeadSingle is not ported yet "
                                      "(ROADMAP A11.1b)")
        ta_cfg = model_cfg["TARGET_ASSIGNER_CONFIG"]
        assigner = str(ta_cfg.get("NAME", "AxisAlignedTargetAssigner"))
        if assigner != "AxisAlignedTargetAssigner":
            raise NotImplementedError(f"TARGET_ASSIGNER_CONFIG.NAME {assigner!r} is not ported yet "
                                      "(ROADMAP A11.4)")
        if float(ta_cfg.get("POS_FRACTION", -1.0)) >= 0:
            raise NotImplementedError("POS_FRACTION subsampling is not supported")
        if bool(ta_cfg.get("MATCH_HEIGHT", False)):
            raise NotImplementedError("MATCH_HEIGHT is used only by the nuScenes configs, not "
                                      "ported yet (ROADMAP A11.4)")
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        self.class_names = list(class_names)
        self.box_coder = _BOX_CODERS[ta_cfg["BOX_CODER"]](
            num_dir_bins=int(ta_cfg.get("NUM_DIR_BINS", 6)), **dict(ta_cfg.get("BOX_CODER_CONFIG", {})))
        anchor_cfgs = list(model_cfg["ANCHOR_GENERATOR_CONFIG"])
        anchors, self.set_sizes = generate_anchors(anchor_cfgs, grid_size, point_cloud_range,
                                                   anchor_ndim=self.box_coder.code_size)
        self.anchors_shape = anchors.shape  # (gy, gx, A_loc, ndim)
        self.register_buffer("anchors", torch.from_numpy(anchors.reshape(-1, anchors.shape[-1])),
                             persistent=False)
        self.num_anchors_per_location = int(sum(self.set_sizes))
        self.anchor_class_names = [c["class_name"] for c in anchor_cfgs]
        self.matched_thresholds = [float(c["matched_threshold"]) for c in anchor_cfgs]
        self.unmatched_thresholds = [float(c["unmatched_threshold"]) for c in anchor_cfgs]
        self.norm_by_num_examples = bool(ta_cfg.get("NORM_BY_NUM_EXAMPLES", False))

        a = self.num_anchors_per_location
        self.conv_cls = nn.Conv2d(input_channels, a * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels, a * self.box_coder.code_size, 1)
        self.use_dir = model_cfg.get("USE_DIRECTION_CLASSIFIER", None) is not None
        if self.use_dir:
            self.num_dir_bins = int(model_cfg["NUM_DIR_BINS"])
            self.dir_offset = float(model_cfg.get("DIR_OFFSET", 0.0))
            self.dir_limit_offset = float(model_cfg.get("DIR_LIMIT_OFFSET", 0.0))
            self.conv_dir_cls = nn.Conv2d(input_channels, a * self.num_dir_bins, 1)

    @torch.no_grad()
    def init_head_(self, generator):
        """The JAX package's initial values of the head: ``conv_cls``'s bias
        at -log((1 - 0.01) / 0.01) and ``conv_box``'s weight normal with std
        0.001, drawn from ``generator`` on the CPU."""
        self.conv_cls.bias.fill_(-float(np.log((1 - 0.01) / 0.01)))
        w = torch.empty(self.conv_box.weight.shape)
        w.normal_(0.0, 0.001, generator=generator)
        self.conv_box.weight.copy_(w)

    def _channels_last(self, conv, x, width):
        b = x.shape[0]
        return conv(x).permute(0, 2, 3, 1).reshape(b, -1, width)

    def forward(self, batch):
        x = batch["spatial_features_2d"]  # (B, C, H, W)
        cls_preds = self._channels_last(self.conv_cls, x, self.num_class)
        box_preds = self._channels_last(self.conv_box, x, self.box_coder.code_size)
        dir_preds = self._channels_last(self.conv_dir_cls, x, self.num_dir_bins) if self.use_dir else None
        out = dict(batch)
        out["head_preds"] = {"cls_preds": cls_preds, "box_preds": box_preds,
                             "dir_cls_preds": dir_preds}
        if self.training:
            out["head_targets"] = self.assign_targets(batch["gt_boxes"])
        if not self.training or self.predict_boxes_when_training:
            out["batch_cls_preds"], out["batch_box_preds"] = self.generate_predicted_boxes(
                cls_preds, box_preds, dir_preds)
            out["cls_preds_normalized"] = False
        return out

    def assign_targets(self, gt_boxes):
        """gt_boxes (B, M, 8), zero rows for padding -> ``box_cls_labels``
        (B, NA) int (-1 ignored, 0 background, else the 1-based class),
        ``box_reg_targets`` (B, NA, code_size), ``reg_weights`` (B, NA)."""
        gy, gx, _, ndim = self.anchors_shape
        b = gt_boxes.shape[0]
        gt_valid = (gt_boxes[..., :7] != 0).any(-1)
        gt_cls = gt_boxes[..., -1].to(torch.int64)
        grid = self.anchors.reshape(gy, gx, -1, ndim)
        labels_sets, tgt_sets, offset = [], [], 0
        for s, cname in enumerate(self.anchor_class_names):
            na_set = self.set_sizes[s]
            anchors = grid[:, :, offset:offset + na_set].reshape(-1, ndim)
            offset += na_set
            sel = gt_valid & (gt_cls == self.class_names.index(cname) + 1)  # (B, M)
            iou = boxes3d_nearest_bev_iou(anchors[:, :7], gt_boxes[..., :7])  # (B, NA, M)
            iou = torch.where(sel[:, None, :], iou, -1.0)
            a2g_max, a2g_idx = iou.max(2)[0], torch.argmax(iou, 2)  # the first best gt
            g2a_max = iou.max(1)[0]
            # gts whose best anchor overlap is 0 are dropped
            g2a_max = torch.where((g2a_max <= 0) | ~sel, -2.0, g2a_max)
            force = ((iou == g2a_max[:, None, :]) & sel[:, None, :] & (iou >= 0)).any(2)
            pos = a2g_max >= self.matched_thresholds[s]
            bg = a2g_max < self.unmatched_thresholds[s]
            cls_of_match = torch.where(torch.gather(sel, 1, a2g_idx),
                                       torch.gather(gt_cls, 1, a2g_idx), 0)
            labels = torch.where(force | pos, cls_of_match,
                                 torch.where(bg, 0, -1)).to(torch.int32)
            matched_gt = torch.gather(gt_boxes[..., :7], 1, a2g_idx[..., None].expand(-1, -1, 7))
            enc = self.box_coder.encode(matched_gt, anchors[None, :, :7].expand(b, -1, -1))
            tgt = torch.where((labels > 0)[..., None], enc, 0.0)
            labels_sets.append(labels.reshape(b, gy, gx, na_set))
            tgt_sets.append(tgt.reshape(b, gy, gx, na_set, -1))
        labels = torch.cat(labels_sets, dim=3).reshape(b, -1)
        targets = torch.cat(tgt_sets, dim=3).reshape(b, labels.shape[1], -1)
        if self.norm_by_num_examples:
            num_examples = torch.clamp((labels >= 0).sum(1, keepdim=True), min=1).to(targets.dtype)
            reg_weights = torch.where(labels > 0, 1.0 / num_examples, 0.0)
        else:
            reg_weights = (labels > 0).to(targets.dtype)
        return {"box_cls_labels": labels, "box_reg_targets": targets, "reg_weights": reg_weights}

    def generate_predicted_boxes(self, cls_preds, box_preds, dir_cls_preds=None):
        """The anchors' decoded boxes (B, NA, 7) beside the class logits."""
        batch_box_preds = self.box_coder.decode(box_preds, self.anchors[None])
        if dir_cls_preds is not None:
            dir_labels = torch.argmax(dir_cls_preds, dim=-1)
            period = 2 * np.pi / self.num_dir_bins
            dir_rot = limit_period(batch_box_preds[..., 6] - self.dir_offset, self.dir_limit_offset,
                                   period)
            heading = dir_rot + self.dir_offset + period * dir_labels.to(batch_box_preds.dtype)
            batch_box_preds = torch.cat([batch_box_preds[..., :6], heading[..., None],
                                         batch_box_preds[..., 7:]], dim=-1)
        if isinstance(self.box_coder, PreviousResidualDecoder):
            heading = limit_period(-(batch_box_preds[..., 6] + np.pi / 2), offset=0.5,
                                   period=np.pi * 2)
            batch_box_preds = torch.cat([batch_box_preds[..., :6], heading[..., None],
                                         batch_box_preds[..., 7:]], dim=-1)
        return cls_preds, batch_box_preds

    def get_direction_target(self, reg_targets):
        """One-hot direction bin of each anchor's target heading."""
        rot_gt = reg_targets[..., 6] + self.anchors[None, :, 6]
        offset_rot = limit_period(rot_gt - self.dir_offset, 0, 2 * np.pi)
        width = torch.tensor(2 * np.pi / self.num_dir_bins, dtype=offset_rot.dtype,
                             device=offset_rot.device)
        dir_targets = torch.clamp(torch.floor(offset_rot / width).to(torch.int64), 0,
                                  self.num_dir_bins - 1)
        return F.one_hot(dir_targets, self.num_dir_bins).to(reg_targets.dtype)

    def get_loss(self, head_preds, head_targets):
        """cls + loc (+ dir) losses. Returns (loss, tb) with
        ``rpn_loss_cls``, ``rpn_loss_loc``, ``rpn_loss_dir`` and ``rpn_loss``."""
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        cls_preds, box_preds = head_preds["cls_preds"], head_preds["box_preds"]
        labels = head_targets["box_cls_labels"]
        reg_targets = head_targets["box_reg_targets"]
        # the global batch's size: each rank's loss is its share
        batch_size = all_reduce_sum(cls_preds.new_full((), float(cls_preds.shape[0])))

        cared, positives, negatives = labels >= 0, labels > 0, labels == 0
        pos_normalizer = torch.clamp(positives.sum(1, keepdim=True).to(cls_preds.dtype), min=1.0)
        reg_weights = positives.to(cls_preds.dtype) / pos_normalizer
        cls_weights = (negatives | positives).to(cls_preds.dtype) / pos_normalizer

        cls_targets = torch.where(cared, labels, 0)
        if self.num_class == 1:
            cls_targets = torch.where(positives, 1, cls_targets)
        one_hot = F.one_hot(cls_targets.to(torch.int64), self.num_class + 1)[..., 1:].to(cls_preds.dtype)
        cls_loss = (sigmoid_focal_cls_loss(cls_preds, one_hot, cls_weights).sum() / batch_size
                    * float(lw["cls_weight"]))
        box_sin, tgt_sin = add_sin_difference(box_preds, reg_targets)
        loc_loss = (weighted_smooth_l1(box_sin, tgt_sin, reg_weights,
                                       code_weights=list(lw["code_weights"])).sum()
                    / batch_size * float(lw["loc_weight"]))
        total = cls_loss + loc_loss
        tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        if self.use_dir and head_preds.get("dir_cls_preds") is not None:
            dir_targets = self.get_direction_target(reg_targets)
            weights = positives.to(cls_preds.dtype)
            weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1.0)
            dir_loss = (weighted_cross_entropy(head_preds["dir_cls_preds"], dir_targets, weights).sum()
                        / batch_size * float(lw["dir_weight"]))
            total = total + dir_loss
            tb["rpn_loss_dir"] = dir_loss
        tb["rpn_loss"] = total
        return total, tb
