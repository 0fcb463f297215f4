"""CenterPoint detector.

Counterpart of ``pcp_tpu/models/detectors/centerpoint.py``: the sub-modules
run in order on a batch dict (``points`` (B, N, C) float32, ``points_mask``
(B, N) bool; in training also ``gt_boxes`` (B, M, 8), zero rows for padding).
In eval mode the result carries fixed-shape ``final_box_dicts`` and, with a
HunterJr corrector (the car and RSU senders), its ``points_cls_prob`` and
``points_flow3d``; in training mode (``model.train()``) it carries ``loss``,
the CenterHead's loss, and ``tb_dict``. The corrector's loss comes with its
training (ROADMAP A7b: ``model.train()`` raises on a sender until then), the
distillation loss with DiscoNet (A9), which ``build_network`` refuses.
"""
from .detector_template import Detector3DTemplate


class CenterPoint(Detector3DTemplate):
    def forward(self, batch):
        out = dict(batch)
        for name in self.module_names:
            out = getattr(self, name)(out)
        if self.training:
            out["loss"], out["tb_dict"] = self.dense_head.get_loss(out["head_preds"],
                                                                   out["head_targets"])
        return out
