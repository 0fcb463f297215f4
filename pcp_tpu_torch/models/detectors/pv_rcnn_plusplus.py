"""PV-RCNN++: counterpart of ``pcp_tpu/models/detectors/pv_rcnn_plusplus.py``.

PV-RCNN's modules with the proposals drawn before the keypoints: the
sparse backbone, the BEV map and the dense head run first, then the ROI
head's proposal layer and, in training, its target sampling, so that the
voxel set abstraction's SPC sampling takes its keypoints about the
proposals (or the sampled ROIs); then the PFE, the point head and the ROI
head, which takes the sampled targets as they are. Losses and
post-processing are PV-RCNN's.
"""
from ..roi_heads.roi_head_template import proposal_layer
from .pvrcnn import PVRCNN

LATE = ("pfe", "point_head", "roi_head")


class PVRCNNPlusPlus(PVRCNN):
    def run_modules(self, out):
        for name in self.module_names:
            if name not in LATE:
                out = getattr(self, name)(out)
        head = self.roi_head
        out = proposal_layer(out, head.model_cfg["NMS_CONFIG"][
            "TRAIN" if self.training else "TEST"])
        if self.training:
            targets = head.sample_targets(out)
            out["rois"], out["roi_labels"] = targets["rois"], targets["roi_labels"]
            out["roi_targets_dict"] = targets
        for name in LATE:
            if name in self.module_names:
                out = getattr(self, name)(out)
        return out
