"""CenterPoint dense head.

Counterpart of ``pcp_tpu/models/dense_heads/center_head.py``: a shared 3x3
conv, then per class group a ``SeparateHead`` of conv towers (hm, center,
center_z, dim, rot). In eval mode the forward ends in fixed-K decode and
rotated NMS; in training it assigns gaussian targets to the gt boxes
(``target_assigner.py``) for :meth:`CenterHead.get_loss` and does not decode
(the JAX package decodes in training only for an ROI head, ROADMAP A11).
Modules and names follow pcdet (``shared_conv.{0,1}``,
``heads_list.{h}.{branch}.{k}.{0,1}``, the branch's last conv at
``{num_conv - 1}``). Head BNs have eps 1e-5 and flax's
convention (``norm.BatchNorm2d``; flax momentum 0.9 is torch momentum 0.1);
conv biases before a BN follow ``USE_BIAS_BEFORE_NORM``; the hm output bias
starts at -2.19. Feature maps are (B, C, H, W); decode, targets and the
heatmap loss take them in the JAX layout (B, H, W, C). With ``BF16`` (or
``bf16=True``, from ``MODEL.BF16``) the convs and BNs serve in bfloat16 as
flax's ``dtype=bfloat16`` does, and each branch's output comes back float32.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import class_agnostic_nms
from ..loss_fnc.centernet_losses import focal_loss_centernet, reg_loss_centernet
from ..model_utils.centernet_utils import decode_bbox_from_heatmap
from ..model_utils.norm import BatchNorm2d
from ..model_utils.precision import Conv2d
from .target_assigner import assign_targets_single_head


def _conv_bn_relu(c_in, c_out, use_bias, dtype=None):
    return nn.Sequential(Conv2d(c_in, c_out, 3, padding=1, bias=use_bias, compute_dtype=dtype),
                         BatchNorm2d(c_out, eps=1e-5, momentum=0.1, compute_dtype=dtype),
                         nn.ReLU())


class SeparateHead(nn.Module):
    def __init__(self, input_channels, sep_head_dict, init_bias=-2.19, use_bias=False,
                 dtype=None):
        super().__init__()
        self.sep_head_dict, self.dtype = sep_head_dict, dtype
        for name, spec in sep_head_dict.items():
            layers = [_conv_bn_relu(input_channels, input_channels, use_bias, dtype)
                      for _ in range(int(spec["num_conv"]) - 1)]
            out = Conv2d(input_channels, int(spec["out_channels"]), 3, padding=1, bias=True,
                         compute_dtype=dtype)
            nn.init.constant_(out.bias, init_bias if name == "hm" else 0.0)
            layers.append(out)
            setattr(self, name, nn.Sequential(*layers))

    def forward(self, x):
        out = {name: getattr(self, name)(x) for name in self.sep_head_dict}
        return out if self.dtype is None else {k: v.float() for k, v in out.items()}


class CenterHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, bf16=False):
        super().__init__()
        self.dtype = torch.bfloat16 if (bf16 or model_cfg.get("BF16", False)) else None
        extra = set(model_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]) - {"center", "center_z", "dim", "rot"}
        if extra or model_cfg["POST_PROCESSING"].get("CALIB_CLS_SCORE", False):
            raise NotImplementedError(f"CenterHead branches {sorted(extra)} and CALIB_CLS_SCORE "
                                      "are not ported yet (ROADMAP A11)")
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.feature_map_stride = int(model_cfg["TARGET_ASSIGNER_CONFIG"].get("FEATURE_MAP_STRIDE", 1))
        class_names = list(class_names)
        self.class_id_mapping_each_head = [
            [class_names.index(x) for x in names if x in class_names]
            for names in model_cfg["CLASS_NAMES_EACH_HEAD"]]
        # per head: global 1-based class -> the head's 1-based class, or 0
        for idx, mapping in enumerate(self.class_id_mapping_each_head):
            local = torch.zeros(num_class + 1, dtype=torch.int64)
            for k, global_id in enumerate(mapping):
                local[global_id + 1] = k + 1
            self.register_buffer(f"head_class_map_{idx}", local, persistent=False)

        shared_ch = int(model_cfg["SHARED_CONV_CHANNEL"])
        use_bias = bool(model_cfg.get("USE_BIAS_BEFORE_NORM", False))
        self.shared_conv = _conv_bn_relu(input_channels, shared_ch, use_bias, self.dtype)
        heads = []
        for mapping in self.class_id_mapping_each_head:
            head_dict = {k: dict(v) for k, v in model_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"].items()}
            head_dict["hm"] = dict(out_channels=len(mapping), num_conv=int(model_cfg["NUM_HM_CONV"]))
            heads.append(SeparateHead(shared_ch, head_dict, use_bias=use_bias, dtype=self.dtype))
        self.heads_list = nn.ModuleList(heads)

    def forward(self, batch):
        if self.training and self.dtype is not None:
            raise NotImplementedError("BF16 training is not ported yet (ROADMAP A13b)")
        x = self.shared_conv(batch["spatial_features_2d"])
        pred_dicts = [head(x) for head in self.heads_list]
        out = dict(batch)
        out["head_preds"] = pred_dicts
        if self.training:
            cap = int(self.model_cfg["TARGET_ASSIGNER_CONFIG"]["NUM_MAX_OBJS"])
            gt = batch["gt_boxes"][:, :cap]  # pad or trim to NUM_MAX_OBJS
            gt = F.pad(gt, (0, 0, 0, cap - gt.shape[1]))
            out["head_targets"] = self.assign_targets(gt, feat_w=x.shape[3], feat_h=x.shape[2])
        else:
            out["final_box_dicts"] = self.generate_predicted_boxes(pred_dicts)
        return out

    def assign_targets(self, gt_boxes, feat_w, feat_h):
        """gt_boxes (B, NUM_MAX_OBJS, 8), zero rows for padding. Returns per
        head {heatmap (B, H, W, C), target_boxes, inds, mask}."""
        ta = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        targets = []
        for idx, mapping in enumerate(self.class_id_mapping_each_head):
            hm, boxes, inds, mask = assign_targets_single_head(
                gt_boxes, getattr(self, f"head_class_map_{idx}"), num_classes=len(mapping),
                feat_w=feat_w, feat_h=feat_h, stride=self.feature_map_stride,
                pc_range=self.point_cloud_range, voxel_size=self.voxel_size,
                gaussian_overlap=float(ta["GAUSSIAN_OVERLAP"]), min_radius=int(ta["MIN_RADIUS"]),
                num_max_objs=int(ta["NUM_MAX_OBJS"]))
            targets.append({"heatmap": hm, "target_boxes": boxes, "inds": inds, "mask": mask})
        return targets

    def get_loss(self, head_preds, head_targets):
        """Focal heatmap loss plus code-weighted L1 at the gt centres, per
        head. Returns (loss, tb_dict) with ``hm_loss_head_{i}``,
        ``loc_loss_head_{i}`` and ``rpn_loss``."""
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        head_order = list(self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])
        total, tb = 0.0, {}
        for idx, (pred, tgt) in enumerate(zip(head_preds, head_targets)):
            hm = torch.clamp(torch.sigmoid(pred["hm"]), 1e-4, 1 - 1e-4).permute(0, 2, 3, 1)
            hm_loss = focal_loss_centernet(hm, tgt["heatmap"]) * float(lw["cls_weight"])

            reg = torch.cat([pred[k] for k in head_order], dim=1)  # (B, D, H, W)
            b, d = reg.shape[:2]
            flat = reg.permute(0, 2, 3, 1).reshape(b, -1, d)  # the JAX layout (B, H*W, D)
            gathered = torch.gather(flat, 1, tgt["inds"][..., None].expand(-1, -1, d))
            reg_loss = reg_loss_centernet(gathered, tgt["mask"], tgt["target_boxes"])
            code_w = reg_loss.new_tensor([float(v) for v in lw["code_weights"]])[:d]
            loc_loss = (reg_loss * code_w).sum() * float(lw["loc_weight"])

            total = total + hm_loss + loc_loss
            tb[f"hm_loss_head_{idx}"] = hm_loss
            tb[f"loc_loss_head_{idx}"] = loc_loss
        tb["rpn_loss"] = total
        return total, tb

    def generate_predicted_boxes(self, pred_dicts):
        """pred_dicts: per head, {branch: (B, C, H, W)}. Returns fixed-shape
        pred_boxes (B, heads*POST, 7), pred_scores, pred_labels (1-based),
        pred_valid."""
        pp = self.model_cfg["POST_PROCESSING"]
        nms_cfg = pp["NMS_CONFIG"]
        all_boxes, all_scores, all_labels, all_valid = [], [], [], []
        for idx, pred in enumerate(pred_dicts):
            pred = {k: v.permute(0, 2, 3, 1) for k, v in pred.items()}  # JAX layout
            decoded = decode_bbox_from_heatmap(
                heatmap=torch.sigmoid(pred["hm"]), rot_cos=pred["rot"][..., 0:1],
                rot_sin=pred["rot"][..., 1:2], center=pred["center"], center_z=pred["center_z"],
                dim=torch.exp(pred["dim"]), point_cloud_range=self.point_cloud_range,
                voxel_size=self.voxel_size, feature_map_stride=self.feature_map_stride,
                k=int(pp["MAX_OBJ_PER_SAMPLE"]), score_thresh=float(pp["SCORE_THRESH"]),
                post_center_limit_range=pp["POST_CENTER_LIMIT_RANGE"])

            keep_idx, _ = class_agnostic_nms(decoded["pred_boxes"], decoded["pred_scores"],
                                             decoded["valid"], nms_cfg)
            sel = keep_idx.clamp(min=0).long()
            valid_k = keep_idx >= 0
            boxes = decoded["pred_boxes"]
            boxes_k = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1]))
            scores_k = torch.gather(decoded["pred_scores"], 1, sel)
            labels_k = torch.gather(decoded["pred_labels"], 1, sel)
            mapping = torch.tensor(self.class_id_mapping_each_head[idx], dtype=torch.int32,
                                   device=boxes.device)
            labels_k = mapping[labels_k.clamp(0, mapping.shape[0] - 1).long()]

            all_boxes.append(boxes_k)
            all_scores.append(torch.where(valid_k, scores_k, 0.0))
            all_labels.append(labels_k)
            all_valid.append(valid_k)
        return {"pred_boxes": torch.cat(all_boxes, 1), "pred_scores": torch.cat(all_scores, 1),
                "pred_labels": torch.cat(all_labels, 1) + 1, "pred_valid": torch.cat(all_valid, 1)}
