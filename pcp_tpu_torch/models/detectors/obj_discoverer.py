"""ObjectDiscoverer: eval-only passthrough of discovered boxes.

Counterpart of ``pcp_tpu/models/detectors/obj_discoverer.py``. A host model
(``is_host_model``), as ``V2XLateFusion`` is: it turns each cloud's
``metadata["disco_boxes"]`` (N, 10) ``[box7, sweep_idx, inst_idx, cls_idx]``
into the fixed-shape ``final_box_dicts`` of the network detectors, with unit
scores and 1-based labels, at most ``POST_PROCESSING.MAX_OBJ_PER_SAMPLE``
(default 500) a cloud. It has nothing to train and launches nothing on the
card.
"""
import numpy as np


class ObjectDiscoverer:
    is_host_model = True

    def __init__(self, model_cfg, num_class, dataset_info):
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset_info = dataset_info
        self.post_process_cfg = model_cfg["POST_PROCESSING"]

    def __call__(self, batch):
        cap = int(self.post_process_cfg.get("MAX_OBJ_PER_SAMPLE", 500))
        b = batch["batch_size"]
        out_boxes = np.zeros((b, cap, 7), np.float32)
        out_scores = np.zeros((b, cap), np.float32)
        out_labels = np.zeros((b, cap), np.int64)
        out_valid = np.zeros((b, cap), bool)
        for i, meta in enumerate(batch["metadata"]):
            disco = np.asarray(meta.get("disco_boxes", np.zeros((0, 10))))
            n = min(disco.shape[0], cap)
            out_boxes[i, :n] = disco[:n, :7]
            out_scores[i, :n] = 1.0
            out_labels[i, :n] = disco[:n, -1].astype(np.int64) + 1  # 0-based -> 1-based
            out_valid[i, :n] = True
        out = dict(batch)
        out["final_box_dicts"] = {"pred_boxes": out_boxes, "pred_scores": out_scores,
                                  "pred_labels": out_labels, "pred_valid": out_valid}
        return out
