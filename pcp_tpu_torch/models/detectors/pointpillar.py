"""PointPillar and SECONDNet: the anchor-head detectors.

Counterpart of ``pcp_tpu/models/detectors/pointpillar.py`` (pcdet's
``pointpillar.py``, ``second_net.py`` and ``Detector3DTemplate.post_processing``):
the sub-modules run in order on the batch dict; in training the result
carries ``loss`` and ``tb_dict``, the anchor head's loss under ``rpn_loss_cls``,
``rpn_loss_loc``, ``rpn_loss_dir``, ``rpn_loss`` and ``loss_rpn``; in eval
mode it carries fixed-shape ``final_box_dicts`` (B, NMS_POST_MAXSIZE) from
:func:`generic_post_processing`.
"""
import torch

from ...ops.nms import class_agnostic_nms
from .detector_template import Detector3DTemplate


def generic_post_processing(model_cfg, batch):
    """The decoded anchors' class-agnostic NMS: sigmoid scores (unless the
    head normalised them), the max over classes as the score, its argmax + 1
    as the label (a two-stage model's: its ROI labels), ``SCORE_THRESH`` and the NMS config's cuts; with
    ``OUTPUT_RAW_SCORE`` a kept box reports its raw logit. Returns
    pred_boxes (B, POST, 7), pred_scores, pred_labels (1-based), pred_valid."""
    pp = model_cfg["POST_PROCESSING"]
    nms_cfg = pp["NMS_CONFIG"]
    if bool(nms_cfg.get("MULTI_CLASSES_NMS", False)):
        raise NotImplementedError("MULTI_CLASSES_NMS is not ported yet (ROADMAP A11.3)")
    src_cls_preds = batch["batch_cls_preds"]  # (B, NA, C)
    box_preds = batch["batch_box_preds"]  # (B, NA, 7)
    cls_preds = src_cls_preds if batch.get("cls_preds_normalized", False) else torch.sigmoid(src_cls_preds)
    max_scores = cls_preds.max(-1)[0]
    # a two-stage model's labels are its ROI stage's
    label_preds = (batch["roi_labels"] if batch.get("has_class_labels", False)
                   else torch.argmax(cls_preds, dim=-1) + 1)
    valid = batch.get("batch_pred_valid")
    if valid is None:
        valid = torch.ones_like(max_scores, dtype=torch.bool)
    keep_idx, _ = class_agnostic_nms(box_preds, max_scores, valid, nms_cfg,
                                     score_thresh=float(pp["SCORE_THRESH"]))
    sel = keep_idx.clamp(min=0).long()
    ok = keep_idx >= 0
    boxes_k = torch.gather(box_preds, 1, sel[..., None].expand(-1, -1, box_preds.shape[-1]))
    scores = src_cls_preds.max(-1)[0] if bool(pp.get("OUTPUT_RAW_SCORE", False)) else max_scores
    return {"pred_boxes": boxes_k, "pred_scores": torch.where(ok, torch.gather(scores, 1, sel), 0.0),
            "pred_labels": torch.gather(label_preds, 1, sel).to(torch.int32), "pred_valid": ok}


class PointPillar(Detector3DTemplate):
    def forward(self, batch):
        out = dict(batch)
        for name in self.module_names:
            out = getattr(self, name)(out)
        if self.training:
            loss, tb = self.dense_head.get_loss(out["head_preds"], out["head_targets"])
            tb["loss_rpn"] = loss
            out["loss"], out["tb_dict"] = loss, tb
        else:
            out["final_box_dicts"] = generic_post_processing(self.model_cfg, out)
        return out


class SECONDNet(PointPillar):
    """pcdet's ``second_net.py``: the control flow of PointPillar."""
