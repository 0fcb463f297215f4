"""Two-stage ROI head machinery: counterpart of
``pcp_tpu/models/roi_heads/roi_head_template.py``.

* :func:`proposal_layer`: the first stage's boxes through class-agnostic NMS
  into fixed-shape ROIs (B, NMS_POST_MAXSIZE) with a validity mask; a
  padding ROI is all zeros, as pcdet's unfilled rows.
* :func:`sample_rois_for_rcnn`: the proposal target layer's foreground,
  hard-background and easy-background quotas filled in that order, each
  group's members taken in the order of random priorities and repeated when
  the group is short. The priorities (one uniform draw a candidate ROI per
  group) come from the caller: the JAX package draws them with
  ``jax.random.uniform``, which no torch generator reproduces, so the port
  draws its own from a ``torch.Generator`` and the parity tests hand in the
  JAX draws.
* :func:`assign_targets`: the sampling per sample, the classification labels
  and the gt turned into each ROI's canonical frame.
* :class:`RoIHeadTemplate`: the FC towers, the BCE, smooth-L1 and corner
  losses and the decoding of the refined boxes.
"""
import math

import torch
from torch import nn

from ...ops.nms import class_agnostic_nms
from ...ops.rotated_iou import boxes_iou3d
from ...utils.box_coder_utils import ResidualCoder
from ..loss_fnc.anchor_losses import weighted_smooth_l1
from ..loss_fnc.corner_loss import get_corner_loss_lidar
from ..model_utils.norm import MaskedBatchNorm

TWO_PI = 2 * math.pi


def rotate_points_along_z(points, angle):
    """points (..., N, 3+C) turned about +z by angle (...)."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xy = torch.stack([x * c - y * s, x * s + y * c], dim=-1)
    return torch.cat([xy, points[..., 2:]], dim=-1)


def proposal_layer(batch, nms_config):
    """First-stage boxes -> rois (B, P, 7+), roi_scores, roi_labels (1-based),
    roi_valid (B, P), P the config's NMS_POST_MAXSIZE."""
    if batch.get("rois") is not None:
        return batch
    if bool(nms_config.get("MULTI_CLASSES_NMS", False)):
        raise NotImplementedError("MULTI_CLASSES_NMS proposals are not ported yet (ROADMAP A11.3)")
    box_preds, cls_preds = batch["batch_box_preds"], batch["batch_cls_preds"]
    if not batch.get("cls_preds_normalized", False):
        cls_preds = torch.sigmoid(cls_preds)
    scores, labels = cls_preds.max(dim=-1).values, torch.argmax(cls_preds, dim=-1) + 1
    valid = batch.get("batch_pred_valid")
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    keep_idx, _ = class_agnostic_nms(box_preds, scores, valid, nms_config)
    sel, ok = keep_idx.clamp(min=0).long(), keep_idx >= 0
    out = dict(batch)
    rois = torch.gather(box_preds, 1, sel[..., None].expand(-1, -1, box_preds.shape[-1]))
    out["rois"] = torch.where(ok[..., None], rois, 0.0)
    out["roi_scores"] = torch.where(ok, torch.gather(scores, 1, sel), 0.0)
    out["roi_labels"] = torch.where(ok, torch.gather(labels, 1, sel), 0)
    out["roi_valid"] = ok
    out["has_class_labels"] = True
    return out


def _pick_group(priority, member, slots, take):
    """Members of (N,) ``member`` in the order of (N,) ``priority``, repeated
    when fewer than ``slots`` -> idx (slots,) and valid (slots,)."""
    pri = priority + torch.where(member, 0.0, 1e3).to(priority.dtype)
    order = torch.argsort(pri, stable=True)
    count = member.sum()
    j = torch.arange(slots, device=member.device)
    return order[j % torch.clamp(count, min=1)], (j < take) & (count > 0)


def sample_rois_for_rcnn(priorities, rois, roi_scores, roi_labels, gt_boxes, sampler_cfg,
                         sample_by_each_class=False):
    """One sample: rois (P, 7+), gt_boxes (G, 8) zero-padded with the 1-based
    class last, priorities (3, P) for the foreground, hard and easy
    background groups. Returns ROI_PER_IMAGE-row tensors."""
    roi_per_image = int(sampler_cfg["ROI_PER_IMAGE"])
    reg_fg = float(sampler_cfg["REG_FG_THRESH"])
    cls_fg = float(sampler_cfg["CLS_FG_THRESH"])
    bg_lo = float(sampler_cfg["CLS_BG_THRESH_LO"])
    hard_ratio = float(sampler_cfg["HARD_BG_RATIO"])
    fg_per_image = int(round(float(sampler_cfg["FG_RATIO"]) * roi_per_image))

    iou = boxes_iou3d(rois[:, :7], gt_boxes[:, :7])
    if sample_by_each_class:
        iou = torch.where(roi_labels[:, None] == gt_boxes[None, :, -1].long(), iou, 0.0)
    iou = torch.where(torch.any(gt_boxes != 0, dim=-1)[None, :], iou, 0.0)
    max_overlaps = iou.max(dim=1).values
    gt_assignment = torch.argmax(iou, dim=1)

    fg = max_overlaps >= min(reg_fg, cls_fg)
    easy = max_overlaps < bg_lo
    hard = (max_overlaps < reg_fg) & (max_overlaps >= bg_lo)
    fg_count, hard_count, easy_count = fg.sum(), hard.sum(), easy.sum()
    fg_take = torch.clamp(fg_count, max=fg_per_image)
    fg_take = torch.where(hard_count + easy_count == 0, roi_per_image, fg_take)
    fg_take = torch.where(fg_count == 0, 0, fg_take)
    bg_take = roi_per_image - fg_take
    ratio_take = (bg_take * hard_ratio).to(torch.int64)
    hard_take = torch.where((hard_count > 0) & (easy_count > 0),
                            torch.minimum(ratio_take, hard_count),
                            torch.where(hard_count > 0, bg_take, 0))
    easy_take = bg_take - hard_take

    fg_idx, fg_ok = _pick_group(priorities[0], fg, roi_per_image, fg_take)
    hard_idx, hard_ok = _pick_group(priorities[1], hard, roi_per_image, hard_take)
    easy_idx, easy_ok = _pick_group(priorities[2], easy, roi_per_image, easy_take)
    j = torch.arange(roi_per_image, device=rois.device)
    in_fg = j < fg_take
    in_hard = (j >= fg_take) & (j < fg_take + hard_take)
    jh = torch.clamp(j - fg_take, min=0)
    je = torch.clamp(j - fg_take - hard_take, min=0)
    sel = torch.where(in_fg, fg_idx, torch.where(in_hard, hard_idx[jh], easy_idx[je]))
    ok = torch.where(in_fg, fg_ok, torch.where(in_hard, hard_ok[jh], easy_ok[je]))
    okf = ok.to(rois.dtype)
    return {"rois": rois[sel] * okf[:, None], "roi_scores": roi_scores[sel] * okf,
            "roi_labels": torch.where(ok, roi_labels[sel], 0),
            "roi_ious": torch.where(ok, max_overlaps[sel], 0.0),
            "gt_of_rois": gt_boxes[gt_assignment[sel]] * okf[:, None],
            "roi_sample_valid": ok, "roi_sel": sel}


def assign_targets(priorities, batch, sampler_cfg, sample_by_each_class=False):
    """Sample each sample's ROIs (``priorities`` (B, 3, P)), label them and
    turn their gt into each ROI's canonical frame (``gt_of_rois``; the
    global-frame gt stays as ``gt_of_rois_src``)."""
    per = [sample_rois_for_rcnn(priorities[i], batch["rois"][i], batch["roi_scores"][i],
                                batch["roi_labels"][i], batch["gt_boxes"][i], sampler_cfg,
                                sample_by_each_class)
           for i in range(batch["rois"].shape[0])]
    t = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    ious, valid = t["roi_ious"], t["roi_sample_valid"]
    reg_fg = float(sampler_cfg["REG_FG_THRESH"])
    cls_fg = float(sampler_cfg["CLS_FG_THRESH"])
    cls_bg = float(sampler_cfg["CLS_BG_THRESH"])
    t["reg_valid_mask"] = ((ious > reg_fg) & valid).to(torch.int32)
    score_type = sampler_cfg.get("CLS_SCORE_TYPE", "roi_iou")
    if score_type == "cls":
        labels = (ious > cls_fg).to(ious.dtype)
        labels = torch.where((ious > cls_bg) & (ious < cls_fg), -1.0, labels)
    elif score_type == "roi_iou":
        fg, bg = ious > cls_fg, ious < cls_bg
        labels = torch.where(~fg & ~bg, (ious - cls_bg) / (cls_fg - cls_bg), fg.to(ious.dtype))
    else:
        raise NotImplementedError(score_type)
    t["rcnn_cls_labels"] = torch.where(valid, labels, -1.0)

    gt = t["gt_of_rois"]
    t["gt_of_rois_src"] = gt
    roi_ry = torch.remainder(t["rois"][..., 6], TWO_PI)
    rotated = rotate_points_along_z((gt[..., 0:3] - t["rois"][..., 0:3])[..., None, :],
                                    -roi_ry)[..., 0, :]
    heading = torch.remainder(gt[..., 6] - roi_ry, TWO_PI)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + math.pi, TWO_PI), heading)
    heading = torch.where(heading > math.pi, heading - TWO_PI, heading)
    heading = torch.clamp(heading, -math.pi / 2, math.pi / 2)
    t["gt_of_rois"] = torch.cat([rotated, gt[..., 3:6], heading[..., None], gt[..., 7:]], dim=-1)
    return t


def make_fc_layers(in_channels, fc_list, out_channels, dp_ratio):
    """pcdet's ROI-head tower: [Linear without bias, BN, ReLU] per width
    (a Dropout after the first where ``dp_ratio`` >= 0), then a biased
    Linear."""
    layers, c = [], in_channels
    for k, width in enumerate(fc_list):
        layers += [nn.Linear(c, int(width), bias=False),
                   MaskedBatchNorm(int(width), eps=1e-5, momentum=0.1), nn.ReLU()]
        c = int(width)
        if dp_ratio >= 0 and k == 0:
            layers.append(nn.Dropout(dp_ratio))
    layers.append(nn.Linear(c, out_channels))
    return nn.Sequential(*layers)


class RoIHeadTemplate(nn.Module):
    """The losses and decoding, and the ROI sampling's priorities: drawn from
    ``self.generator`` (a CPU ``torch.Generator``, seed 0 until
    :meth:`reseed`), or the batch's ``roi_sampling_priorities`` (B, 3, P)
    where it has them."""

    def __init__(self, model_cfg, num_class):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        coder_cfg = model_cfg["TARGET_CONFIG"].get("BOX_CODER_CONFIG", {})
        self.box_coder = ResidualCoder(**{k.lower(): v for k, v in coder_cfg.items()})
        self.generator = torch.Generator().manual_seed(0)

    def reseed(self, seed):
        self.generator.manual_seed(int(seed))

    def sampling_priorities(self, batch, num_rois):
        pri = batch.get("roi_sampling_priorities")
        if pri is None:
            pri = torch.rand((batch["rois"].shape[0], 3, num_rois), generator=self.generator)
        return pri.to(batch["rois"].device)

    def get_box_cls_layer_loss(self, fwd):
        cfg = self.model_cfg["LOSS_CONFIG"]
        if cfg["CLS_LOSS"] != "BinaryCrossEntropy":
            raise NotImplementedError(cfg["CLS_LOSS"])
        rcnn_cls = fwd["rcnn_cls"].reshape(-1)
        labels = fwd["rcnn_cls_labels"].reshape(-1)
        p = torch.sigmoid(rcnn_cls)
        eps = 1e-7
        bce = -(labels * torch.log(torch.clamp(p, eps, 1.0))
                + (1 - labels) * torch.log(torch.clamp(1 - p, eps, 1.0)))
        valid = (labels >= 0).to(bce.dtype)
        loss = (bce * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        loss = loss * float(cfg["LOSS_WEIGHTS"]["rcnn_cls_weight"])
        return loss, {"rcnn_loss_cls": loss}

    def get_box_reg_layer_loss(self, fwd):
        cfg = self.model_cfg["LOSS_CONFIG"]
        code_size = self.box_coder.code_size
        rois = fwd["rois"].reshape(-1, fwd["rois"].shape[-1])[:, :code_size]
        gt_ct = fwd["gt_of_rois"][..., 0:code_size].reshape(-1, code_size)
        gt_src = fwd["gt_of_rois_src"][..., 0:code_size].reshape(-1, code_size)
        rcnn_reg = fwd["rcnn_reg"].reshape(-1, code_size)
        fg_mask = (fwd["reg_valid_mask"].reshape(-1) > 0).to(rcnn_reg.dtype)
        fg_sum = torch.clamp(fg_mask.sum(), min=1.0)
        zeros = torch.zeros_like(rois[:, 0:1])
        rois_anchor = torch.cat([zeros, zeros, zeros, rois[:, 3:6], zeros], dim=-1)
        reg_targets = self.box_coder.encode(gt_ct, rois_anchor)
        l1 = weighted_smooth_l1(rcnn_reg[None], reg_targets[None],
                                code_weights=cfg["LOSS_WEIGHTS"].get("code_weights"))[0]
        loss_reg = (l1 * fg_mask[:, None]).sum() / fg_sum
        loss_reg = loss_reg * float(cfg["LOSS_WEIGHTS"]["rcnn_reg_weight"])
        tb = {"rcnn_loss_reg": loss_reg}
        if bool(cfg.get("CORNER_LOSS_REGULARIZATION", False)):
            decoded = self.box_coder.decode(rcnn_reg, rois_anchor)
            roi_ry = rois[:, 6]
            xyz = rotate_points_along_z(decoded[:, None, 0:3], roi_ry)[:, 0]
            boxes_global = torch.cat([xyz + rois[:, 0:3], decoded[:, 3:6],
                                      decoded[:, 6:7] + roi_ry[:, None]], dim=-1)
            corner = get_corner_loss_lidar(boxes_global[:, :7], gt_src[:, :7])
            loss_corner = (corner * fg_mask).sum() / fg_sum
            loss_corner = loss_corner * float(cfg["LOSS_WEIGHTS"]["rcnn_corner_weight"])
            loss_reg = loss_reg + loss_corner
            tb["rcnn_loss_corner"] = loss_corner
        return loss_reg, tb

    def get_loss(self, fwd):
        cls_loss, tb = self.get_box_cls_layer_loss(fwd)
        reg_loss, tb2 = self.get_box_reg_layer_loss(fwd)
        tb.update(tb2)
        tb["rcnn_loss"] = cls_loss + reg_loss
        return tb["rcnn_loss"], tb

    def generate_predicted_boxes(self, rois, box_preds):
        """(B, M, 7) ROIs and their residuals -> global boxes: decoded about
        the ROI with its centre at the origin and its heading kept, then
        turned by the ROI's heading and moved to its centre."""
        zeros = torch.zeros_like(rois[..., 0:3])
        decoded = self.box_coder.decode(box_preds, torch.cat([zeros, rois[..., 3:7]], dim=-1))
        xyz = rotate_points_along_z(decoded[..., None, 0:3], rois[..., 6])[..., 0, :]
        return torch.cat([xyz + rois[..., 0:3], decoded[..., 3:self.box_coder.code_size]], dim=-1)
