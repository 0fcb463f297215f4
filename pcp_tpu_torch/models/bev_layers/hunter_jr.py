"""HunterJr scene-flow corrector.

Counterpart of ``pcp_tpu/models/bev_layers/hunter_jr.py``: a 3x3 conv on the
backbone's BEV, per-point features sampled from it, a point head that
classifies each point (background / static / dynamic) and predicts its
scene flow, dynamic points moved by their flow and sampled again, the point
features mean-scattered into a corrected BEV, and a learned 2-way softmax
that blends the two images. It also emits ``points_cls_prob`` (sigmoid) and
``points_flow3d``, which the exchange writer broadcasts (the JAX package
emits them in eval only; in training the checks of the corrector's discrete
decisions read them).

In training (a batch with ``instances_tf``) the object head pools the
foreground points into dense locals, one per (cloud, instance, sweep), and
decodes a rigid transform for each; the corrector's loss is CE+Lovász on
the point classes, smooth-L1 on the instance embedding, the hard-mined
offset, translation, rotation and reconstruction losses and the
local-feature distillation, returned as ``corrector_loss`` and
``corrector_tb``. A teacher BEV (``teacher_spatial_features_2d``,
(B, C, H, W)), if the batch has one, adds the diagnostic ``l_dtl_bev_img``
to the tb, never to the loss, as in the reference. Training also zeroes the
gt boxes whose centre lies outside the point-cloud range before the dense
head reads them.

Modules and names follow pcdet (``conv_input.{0,1}``,
``point_head.<mlp>.<idx>``, ``object_head.<mlp>.<idx>``,
``conv_weightor.0.{0,1}``, ``conv_weightor.1``). Feature maps are
(B, C, H, W); the gather and the scatter work on channels-last copies, as
the JAX package does.
"""
import torch
from torch import nn

from ...parallel.collective import all_reduce_sum
from ..loss_fnc.lovasz import ce_lovasz_loss
from ..model_utils.norm import BatchNorm2d
from .hunter_toolbox import (MLP, bev_scatter, bilinear_interpolate_bev,
                             hard_mining_regression_loss, quat2mat)


def conv_bn_relu(c_in, c_out):
    """3x3 conv without bias, flax-convention BN (eps 1e-3; flax momentum
    0.99 is torch momentum 0.01), ReLU."""
    return nn.Sequential(nn.Conv2d(c_in, c_out, 3, padding=1, bias=False),
                         BatchNorm2d(c_out, eps=1e-3, momentum=0.01), nn.ReLU())


def smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _masked_mean(err, mask):
    """Mean of ``err`` over ``mask``, divided by max(count, 1) as float32:
    this rank's sum over the global count."""
    count = all_reduce_sum(mask.sum()).clamp(min=1).to(err.dtype)
    return torch.where(mask, err, err.new_zeros(())).sum() / count


class HunterPointHead(nn.Module):
    def __init__(self, num_point_features, hidden_channels=()):
        super().__init__()
        c = num_point_features
        self.local_feat_predictor = MLP(c, c, hidden_channels, is_head=False)
        self.seg = MLP(c, 3, hidden_channels)
        self.reg_flow3d = MLP(c, 3, hidden_channels)
        self.instance_embedding = MLP(c, 2, hidden_channels)

    def forward(self, points_feat, valid):
        """(P, C) features -> local features (P, C), class logits (P, 3),
        flow (P, 3) and, in training, the instance embedding (P, 2) (None in
        eval: only the losses read it)."""
        local_feat = self.local_feat_predictor(points_feat, valid)
        final_feat = points_feat + local_feat
        inst_embed = self.instance_embedding(final_feat, valid) if self.training else None
        return (local_feat, self.seg(final_feat, valid), self.reg_flow3d(final_feat, valid),
                inst_embed)


def _scatter_max_into_zeros(lid, values, num_locals):
    """``zeros(num_locals, C).at[lid].max(values, mode="drop")``: rows with
    lid == num_locals go to a sentinel row that is cut off. The gradient of
    a tie is split evenly among the tied rows and the zero it started from,
    as JAX splits it."""
    out = values.new_zeros((num_locals + 1, values.shape[1]))
    idx = lid[:, None].expand(-1, values.shape[1])
    return out.scatter_reduce(0, idx, values, "amax", include_self=True)[:num_locals]


class HunterObjectHead(nn.Module):
    """Dense-local pooling of the foreground points and the per-local
    transform, as the JAX package lays it out: local ``(b * Ni + inst) * S
    + sweep``, instance-level pooling as a max over the sweep axis."""

    def __init__(self, num_point_features, hidden_channels=()):
        super().__init__()
        c = num_point_features
        self.points_shape_encoder = MLP(3, c, hidden_channels, is_head=False)
        self.local_feat_encoder = MLP(2 * c + 6, c, hidden_channels, is_head=False)
        self.local_tf_decoder = MLP(c, 7)

    def forward(self, fg_xyz, fg_feat, fg_lid, fg_valid, num_locals, s):
        """fg_xyz (P, 3), fg_feat (P, C), fg_lid (P,) dense local id in
        [0, num_locals), fg_valid (P,) bool; num_locals = B * Ni * S, s the
        sweeps. Returns locals_tf (L, 7), locals_feat (L, C), locals_valid
        (L,) and locals_centroid (L, 3)."""
        c = fg_feat.shape[1]
        zero = fg_feat.new_zeros(())
        lid = torch.where(fg_valid, fg_lid, num_locals)
        valid_col = fg_valid[:, None]

        cnt = fg_feat.new_zeros(num_locals + 1).index_add_(0, lid, fg_valid.to(fg_feat.dtype))
        cnt = cnt[:num_locals]
        locals_valid = cnt > 0
        xyz_sum = fg_xyz.new_zeros((num_locals + 1, 3)).index_add_(
            0, lid, torch.where(valid_col, fg_xyz, zero))[:num_locals]
        locals_centroid = xyz_sum / torch.clamp(cnt, min=1.0)[:, None]
        centered = fg_xyz - locals_centroid[lid.clamp(max=num_locals - 1)]

        shape_pts = self.points_shape_encoder(centered, fg_valid)
        shape_enc = _scatter_max_into_zeros(lid, torch.where(valid_col, shape_pts, zero), num_locals)
        feat_max = _scatter_max_into_zeros(lid, torch.where(valid_col, fg_feat, zero), num_locals)
        locals_feat = feat_max + shape_enc

        # instance level: the dense grid reduced over the sweep axis; amax
        # splits the gradient among ties as jnp.max does
        ni_total = num_locals // s
        lf = locals_feat.reshape(ni_total, s, c)
        lv = locals_valid.reshape(ni_total, s)
        globals_feat = torch.amax(torch.where(lv[..., None], lf, lf.new_full((), float("-inf"))),
                                  dim=1)
        globals_feat = torch.where(lv.any(1)[:, None], globals_feat, zero)

        # the target local: the occupied local of the latest sweep
        sweep_ids = torch.arange(s, device=lv.device)
        max_sweep = torch.where(lv, sweep_ids, -1).amax(1).clamp(min=0)
        cent = locals_centroid.reshape(ni_total, s, 3)
        target_centroid = cent[torch.arange(ni_total, device=lv.device), max_sweep]

        full = torch.cat([locals_feat, globals_feat.repeat_interleave(s, 0), locals_centroid,
                          target_centroid.repeat_interleave(s, 0)], dim=1)
        locals_feat = self.local_feat_encoder(full, locals_valid)
        return self.local_tf_decoder(locals_feat), locals_feat, locals_valid, locals_centroid


class HunterJr(nn.Module):
    def __init__(self, model_cfg, info, num_bev_features, input_channels=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_sweeps = int(model_cfg["NUM_SWEEPS"])
        self.thresh_point_cls_prob = float(model_cfg.get("THRESHOLD_POINT_CLS_PROB", 0.3))
        self.sweep_col = int(model_cfg.get("META_POINTS_FEAT_LOCATION_SWEEP_IDX", -2))
        self.inst_col = int(model_cfg.get("META_POINTS_FEAT_LOCATION_INSTANCE_IDX", -1))
        stride = int(model_cfg["BEV_IMAGE_STRIDE"])
        # the JAX order: float32 voxel size times the stride
        self.register_buffer("pixel_size",
                             torch.tensor(info.voxel_size[:2], dtype=torch.float32) * stride,
                             persistent=False)
        self.register_buffer("pc_range", torch.tensor(info.point_cloud_range, dtype=torch.float32),
                             persistent=False)
        c = num_bev_features  # the JAX package's width; CONV_INPUT_CHANNELS is not read
        # conv_input maps the backbone's width to the corrector's; they differ
        # behind an SCConv backbone (the detector's docstring)
        self.conv_input = conv_bn_relu(input_channels or c, c)
        self.point_head = HunterPointHead(c, tuple(model_cfg.get("POINT_HEAD_HIDDEN_CHANNELS", [])))
        self.object_head = HunterObjectHead(c, tuple(model_cfg.get("OBJ_HEAD_HIDDEN_CHANNELS", [])))
        self.conv_weightor = nn.Sequential(conv_bn_relu(2 * c, 2 * c),
                                           nn.Conv2d(2 * c, 2, 3, padding=1, bias=True))

    def forward(self, batch):
        bev_img = self.conv_input(batch["spatial_features_2d"])
        corrected, cls_prob, flow3d, point = self.correct_points(batch, bev_img)
        out = dict(batch)
        if self.training and "instances_tf" in batch:
            out["corrector_loss"], out["corrector_tb"] = self.train_loss(batch, *point)
        out["spatial_features_2d"] = self.blend(bev_img, corrected)
        out["points_cls_prob"] = cls_prob
        out["points_flow3d"] = flow3d
        if not self.training:
            return out
        if "teacher_spatial_features_2d" in batch:
            fused, teacher = out["spatial_features_2d"], batch["teacher_spatial_features_2d"]
            if fused.shape != teacher.shape:
                raise ValueError(f"the corrector's BEV {tuple(fused.shape)} and the teacher's "
                                 f"{tuple(teacher.shape)} differ in shape: the JAX package "
                                 "cannot train this config either (ROADMAP C)")
            if "corrector_tb" in out:
                out["corrector_tb"]["l_dtl_bev_img"] = self.teacher_diagnostic(fused, teacher)
        if "gt_boxes" in batch:
            # the reference drops gt outside the range before the dense head;
            # with static shapes their rows become zeros (class 0: ignored)
            gt = batch["gt_boxes"]
            lo, hi = self.pc_range[:3], self.pc_range[3:]
            keep = ((gt[..., 0:3] >= lo) & (gt[..., 0:3] < hi)).all(-1)
            out["gt_boxes"] = torch.where(keep[..., None], gt, gt.new_zeros(()))
        return out

    def correct_points(self, batch, bev_img):
        """Point head, dynamic points moved by their flow and sampled again,
        mean-scatter. Returns the corrected BEV (B, C, H, W), the class
        probabilities and the flow, each (B, N, 3), and what the training
        losses read: the flat sampled features (B*N, C), the point head's
        local features, class logits, flow and instance embedding."""
        points, pmask = batch["points"], batch["points_mask"]
        b, c, h, w = bev_img.shape
        n = points.shape[1]
        img = bev_img.permute(0, 2, 3, 1).contiguous()
        xy = points[..., 0:2]
        points_feat, _ = bilinear_interpolate_bev(img, xy, self.pc_range, self.pixel_size)
        flat_feat = points_feat.reshape(b * n, c)
        local_feat, cls_logit, flow3d, inst_embed = self.point_head(flat_feat, pmask.reshape(b * n))
        cls_prob = torch.sigmoid(cls_logit).reshape(b, n, 3)
        flow = flow3d.reshape(b, n, 3)

        dyn, moved_xy = self.move_points(xy, cls_prob, flow, pmask)
        feat, coord = bilinear_interpolate_bev(img, moved_xy, self.pc_range, self.pixel_size)
        del img
        feat = torch.where(dyn, feat, points_feat)
        del points_feat
        corrected = bev_scatter(coord, feat, pmask, h, w)
        point = (flat_feat, local_feat, cls_logit, flow3d, inst_embed) if self.training else ()
        return corrected.permute(0, 3, 1, 2).contiguous(), cls_prob, flow, point

    def move_points(self, xy, cls_prob, flow, pmask):
        """The corrector's decision: a valid point whose largest class
        probability is over the threshold and is the dynamic class's moves by
        its flow. Returns the (B, N, 1) mask of moved points and the xy where
        every point is sampled again."""
        max_prob, max_idx = torch.max(cls_prob, dim=-1)  # first index of the max, as jnp.argmax
        dyn = ((max_prob > self.thresh_point_cls_prob) & (max_idx == 2) & pmask)[..., None]
        return dyn, torch.where(dyn, xy + flow[..., 0:2], xy)

    def blend(self, bev_img, corrected):
        """The learned 2-way softmax weighting of the two images."""
        weights = torch.softmax(self.conv_weightor(torch.cat([bev_img, corrected], dim=1)), dim=1)
        return bev_img * weights[:, 0:1] + corrected * weights[:, 1:2]

    def train_loss(self, batch, flat_feat, flat_local_feat, cls_logit, flow3d, inst_embed):
        """The corrector's targets and losses (the JAX package's
        ``_train_branch``). Returns (loss, tb dict of scalars)."""
        points, pmask = batch["points"], batch["points_mask"]
        b, n = points.shape[:2]
        s = self.num_sweeps
        instances_tf = batch["instances_tf"]  # (B, Ni, S, 4, 4)
        ni = instances_tf.shape[1]
        num_locals = b * ni * s
        dev = points.device
        zero = points.new_zeros(())

        inst = points[..., self.inst_col].to(torch.int64)  # truncates toward 0, as astype(int32)
        sweep = points[..., self.sweep_col].to(torch.int64)
        mask_fg = (inst > -1) & pmask & (inst < ni)
        lid = (torch.arange(b, device=dev)[:, None] * ni + inst.clamp(min=0)) * s + sweep.clamp(0, s - 1)
        flat_xyz = points[..., 0:3].reshape(b * n, 3)
        flat_fg = mask_fg.reshape(b * n)
        flat_lid = lid.reshape(b * n)
        fg_lid = flat_lid.clamp(0, num_locals - 1)

        locals_tf_pred, locals_feat, locals_valid, _ = self.object_head(
            flat_xyz, flat_feat, flat_lid, flat_fg, num_locals, s)

        # targets (the reference's assign_target)
        tgt_locals_tf = instances_tf.reshape(num_locals, 4, 4)[:, :3, :]  # (L, 3, 4)
        inst_mos = torch.linalg.vector_norm(instances_tf[:, :, 0, :3, 3], dim=-1) > 0.5  # (B, Ni)
        flat_inst_mos = inst_mos.reshape(b * ni)
        fg_mos = flat_inst_mos[(flat_lid // s).clamp(0, b * ni - 1)] & flat_fg
        local_inst = (torch.arange(num_locals, device=dev) // s).clamp(0, b * ni - 1)
        mask_locals_mos = flat_inst_mos[local_inst] & locals_valid
        # point class: 0 background, 1 static foreground, 2 dynamic foreground
        tgt_cls = torch.where(flat_fg, torch.where(fg_mos, 2, 1), 0)
        # embedding: gt box centre minus the point, rows of gt_boxes indexed by
        # the raw instance id, as the reference indexes them
        gt = batch["gt_boxes"]
        ng = gt.shape[1]
        inst_row = torch.arange(b, device=dev)[:, None] * ng + inst.clamp(0, ng - 1)
        tgt_embed = gt[..., 0:2].reshape(b * ng, 2)[inst_row.reshape(-1)] - flat_xyz[:, 0:2]
        # offset: the point moved by its local's gt transform, minus the point
        fg_tf = tgt_locals_tf[fg_lid]
        corrected = torch.einsum("pij,pj->pi", fg_tf[:, :, :3], flat_xyz) + fg_tf[:, :, 3]

        hard_fg = int(self.model_cfg.get("LOSS_HARD_MINING_STATIC_FG_COEF", 1))
        hard_locals = int(self.model_cfg.get("LOSS_HARD_MINING_STATIC_LOCALS_COEF", 1))
        tb = {}
        tb["l_points_cls"] = l_cls = ce_lovasz_loss(cls_logit, tgt_cls, pmask.reshape(b * n), 3)
        tb["l_points_embed"] = l_embed = _masked_mean(smooth_l1(inst_embed - tgt_embed).sum(1),
                                                      flat_fg)
        tb["l_fg_offset"] = l_offset = hard_mining_regression_loss(
            smooth_l1(flow3d - (corrected - flat_xyz)).sum(1), fg_mos, flat_fg, hard_fg)
        tb["l_locals_transl"] = l_transl = hard_mining_regression_loss(
            smooth_l1(locals_tf_pred[:, :3] - tgt_locals_tf[:, :, 3]).sum(1), mask_locals_mos,
            locals_valid, hard_locals)
        pred_rot = quat2mat(locals_tf_pred[:, 3:])
        rot_err = torch.linalg.vector_norm((pred_rot - tgt_locals_tf[:, :, :3]).reshape(num_locals, 9),
                                           dim=1)
        tb["l_locals_rot"] = l_rot = hard_mining_regression_loss(rot_err, mask_locals_mos,
                                                                 locals_valid, hard_locals)
        # reconstruction: the predicted local transform applied to the points
        pred_tf = torch.cat([pred_rot, locals_tf_pred[:, :3, None]], dim=-1)[fg_lid]
        pred_corrected = torch.einsum("pij,pj->pi", pred_tf[:, :, :3], flat_xyz) + pred_tf[:, :, 3]
        tb["l_recon"] = l_recon = hard_mining_regression_loss(
            smooth_l1(pred_corrected - corrected).sum(1), fg_mos, flat_fg, hard_fg) * 0.1
        # the local features distilled into the point head
        l_dtl = _masked_mean(smooth_l1(flat_local_feat - locals_feat[fg_lid]).sum(1), flat_fg) * 0.1
        any_fg = all_reduce_sum(flat_fg.sum()) > 0
        tb["l_dtl_locals_feat"] = l_dtl = torch.where(any_fg, l_dtl, zero)
        l_transl, l_rot, l_recon = (torch.where(any_fg, v, zero) for v in (l_transl, l_rot, l_recon))
        loss = l_cls + l_embed + l_offset + l_transl + l_rot + l_recon + l_dtl
        return loss, tb

    @staticmethod
    def teacher_diagnostic(fused, teacher):
        """Smooth-L1 between the blended BEV and the teacher's, summed over
        channels and averaged over the pixels where the teacher is not ~0.
        The forward refuses a teacher whose BEV differs from the corrector's
        in shape, as the JAX package's step fails on it: behind an SCConv
        backbone the corrector is the scatter's width (64), the teacher's
        BEV the backbone's (384) (ROADMAP C)."""
        tmask = torch.linalg.vector_norm(teacher, dim=1) > 1e-3
        return _masked_mean(smooth_l1(fused - teacher).sum(1), tmask)
