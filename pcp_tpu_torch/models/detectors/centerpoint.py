"""CenterPoint detector.

Counterpart of ``pcp_tpu/models/detectors/centerpoint.py``: the sub-modules
run in order on a batch dict (``points`` (B, N, C) float32, ``points_mask``
(B, N) bool; in training also ``gt_boxes`` (B, M, 8), zero rows for padding).
In eval mode the result carries fixed-shape ``final_box_dicts`` and, with a
HunterJr corrector (the car and RSU senders), its ``points_cls_prob`` and
``points_flow3d``; in training mode (``model.train()``) it carries ``loss``
and ``tb_dict``: the CenterHead's loss plus, on a sender whose batch holds
``instances_tf`` (B, Ni, S, 4, 4), the corrector's (``corrector_loss`` and
its terms in the tb), and on DiscoNet the mid fusion's ``distill_loss``
against the early-fusion teacher BEV.
"""
from .detector_template import Detector3DTemplate


class CenterPoint(Detector3DTemplate):
    def forward(self, batch):
        out = dict(batch)
        for name in self.module_names:
            out = getattr(self, name)(out)
        if self.training:
            loss, tb = self.dense_head.get_loss(out["head_preds"], out["head_targets"])
            if "corrector_loss" in out:
                loss = loss + out["corrector_loss"]
                tb["corrector_loss"] = out["corrector_loss"]
                tb.update(out["corrector_tb"])
            if "distill_loss" in out:
                loss = loss + out["distill_loss"]
                tb["distill_loss"] = out["distill_loss"]
            out["loss"], out["tb_dict"] = loss, tb
        return out
