"""PointRCNN, the point-based two-stage detector: counterpart of
``pcp_tpu/models/detectors/pointrcnn.py``.

PointNet2MSG over the raw points, PointHeadBox's per-point proposals,
PointRCNNHead's refinement. The training loss is the point head's plus the
ROI head's, their terms in ``tb_dict``; in eval mode ``final_box_dicts`` is
the post-processing NMS over the refined boxes with the ROI stage's labels.
"""
from .detector_template import Detector3DTemplate
from .pointpillar import generic_post_processing


class PointRCNN(Detector3DTemplate):
    def forward(self, batch):
        out = dict(batch)
        for name in self.module_names:
            out = getattr(self, name)(out)
        if self.training:
            out["loss"] = out["point_head_loss"] + out["roi_head_loss"]
            out["tb_dict"] = {**out["point_head_tb"], **out["roi_head_tb"]}
        else:
            out["final_box_dicts"] = generic_post_processing(self.model_cfg, out)
        return out
