"""PV-RCNN, the voxel backbone with keypoint refinement: counterpart of
``pcp_tpu/models/detectors/pvrcnn.py``.

The sparse voxel backbone, the BEV map and the anchor head's proposals, the
voxel set abstraction's keypoint features, PointHeadSimple's keypoint
scores and PVRCNNHead's refinement. The training loss is the anchor head's,
the point head's and the ROI head's, their terms in ``tb_dict``; in eval
mode ``final_box_dicts`` is the post-processing NMS over the refined boxes
with the ROI stage's labels.
"""
from .detector_template import Detector3DTemplate
from .pointpillar import generic_post_processing


class PVRCNN(Detector3DTemplate):
    def run_modules(self, out):
        for name in self.module_names:
            out = getattr(self, name)(out)
        return out

    def forward(self, batch):
        out = self.run_modules(dict(batch))
        if self.training:
            rpn_loss, tb = self.dense_head.get_loss(out["head_preds"], out["head_targets"])
            out["loss"] = rpn_loss + out["point_head_loss"] + out["roi_head_loss"]
            out["tb_dict"] = {**tb, **out["point_head_tb"], **out["roi_head_tb"]}
        else:
            out["final_box_dicts"] = generic_post_processing(self.model_cfg, out)
        return out
