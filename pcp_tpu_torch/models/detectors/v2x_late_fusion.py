"""Late fusion: no network, a merge of every agent's exchanged boxes.

Counterpart of ``pcp_tpu/models/detectors/v2x_late_fusion.py``. A host
model (``is_host_model``): it runs in numpy on the host, since its inputs are
ragged per-agent box lists (``metadata["exchange_boxes"]``, one (N, 9) array
of box7, score and label a lidar id), and launches nothing on the card.
``BOX_FUSION_METHOD``:

* ``nms``: the boxes of every agent at or above ``SCORE_THRESH``, the best
  ``NMS_PRE_MAXSIZE`` by score, class-agnostic greedy rotated BEV NMS;
* ``weighted_nms``: the same clusters, each keeper's geometry the
  score-weighted mean of its cluster (``weighted_nms_bev_np``);
* ``ego_only``: the ego's (lidar id 1) boxes as they came.

Each cloud keeps at most ``NMS_POST_MAXSIZE`` boxes in the fixed-shape
``final_box_dicts`` of the network detectors. ``DATA_CONFIG.BOX_FUSION_EGO_WEIGHT``
of the late config is read by neither package.
"""
import numpy as np

from ...utils.nms_np import nms_bev_np, weighted_nms_bev_np


class V2XLateFusion:
    is_host_model = True

    def __init__(self, model_cfg, num_class, dataset_info):
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset_info = dataset_info
        self.post_process_cfg = model_cfg["POST_PROCESSING"]

    def _merge(self, exchange, method, nms_cfg, score_thresh, post_max):
        """(boxes (N, 9), selected rows) of one cloud."""
        if method == "ego_only":
            boxes = exchange.get(1, np.zeros((0, 9)))
            return boxes, np.arange(min(boxes.shape[0], post_max))
        if method not in ("nms", "weighted_nms"):
            raise NotImplementedError(f"BOX_FUSION_METHOD: {method}")
        stacks = [bx for bx in exchange.values() if bx.shape[0] > 0]
        if not stacks:
            return None, []
        boxes = np.concatenate(stacks)
        boxes = boxes[boxes[:, -2] >= score_thresh]
        if boxes.shape[0] == 0:
            return None, []
        boxes = boxes[np.argsort(-boxes[:, -2])[: int(nms_cfg["NMS_PRE_MAXSIZE"])]]
        thresh = float(nms_cfg["NMS_THRESH"])
        if method == "nms":
            return boxes, nms_bev_np(boxes[:, :7], boxes[:, -2], thresh)[:post_max]
        fused, sel = weighted_nms_bev_np(boxes[:, :7], boxes[:, -2], thresh)
        sel = sel[:post_max]
        boxes = boxes.copy()
        boxes[sel, :7] = fused[: len(sel)]
        return boxes, sel

    def __call__(self, batch):
        nms_cfg = self.post_process_cfg["NMS_CONFIG"]
        score_thresh = float(self.post_process_cfg.get("SCORE_THRESH", 0.0))
        method = self.model_cfg.get("BOX_FUSION_METHOD", "nms")
        post_max = int(nms_cfg["NMS_POST_MAXSIZE"])
        b = batch["batch_size"]
        out_boxes = np.zeros((b, post_max, 7), dtype=np.float32)
        out_scores = np.zeros((b, post_max), dtype=np.float32)
        out_labels = np.zeros((b, post_max), dtype=np.int64)
        out_valid = np.zeros((b, post_max), dtype=bool)
        for i, meta in enumerate(batch["metadata"]):
            boxes, sel = self._merge(meta["exchange_boxes"], method, nms_cfg, score_thresh,
                                     post_max)
            n = len(sel)
            if n == 0:
                continue
            out_boxes[i, :n] = boxes[sel, :7]
            out_scores[i, :n] = boxes[sel, -2]
            out_labels[i, :n] = boxes[sel, -1].astype(np.int64)
            out_valid[i, :n] = True
        out = dict(batch)
        out["final_box_dicts"] = {"pred_boxes": out_boxes, "pred_scores": out_scores,
                                  "pred_labels": out_labels, "pred_valid": out_valid}
        return out
