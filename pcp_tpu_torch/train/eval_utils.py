"""Host-side exchange writer: counterpart of
``pcp_tpu/train/eval_utils.py::make_exchange_writer`` and of the outputs
``workspace/v2x_gen_exchange_database.py`` keeps for it."""
import numpy as np
import torch

from ..exchange.database import pool_box_flow


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_exchange_writer(exchange_db, bg_prob_thresh=0.3):
    """``writer(batch, out)`` broadcasts each cloud of a sender's eval
    forward: ``modar`` (its valid boxes, score and label), ``foreground``
    (the valid points whose background probability is under
    ``bg_prob_thresh``, with their class probabilities and flow) and
    ``boxflow`` (the boxes with the mean flow of their foreground points).
    ``batch`` holds ``points``, ``points_mask`` and ``metadata``, a list of
    ``{"sample_token", "lidar_id"}`` per cloud; ``out`` is the forward's
    result. Tensors may lie on any device."""

    def writer(batch, out):
        fbd = {k: _np(v) for k, v in out["final_box_dicts"].items()}
        points, pmask = _np(batch["points"]), _np(batch["points_mask"])
        cls_prob = _np(out["points_cls_prob"]) if "points_cls_prob" in out else None
        flow = _np(out["points_flow3d"]) if "points_flow3d" in out else None

        for i, meta in enumerate(batch["metadata"]):
            token, lid = meta["sample_token"], int(meta["lidar_id"])
            valid = fbd["pred_valid"][i]
            modar = None
            if valid.any():
                modar = np.concatenate([fbd["pred_boxes"][i][valid][:, :7],
                                        fbd["pred_scores"][i][valid][:, None],
                                        fbd["pred_labels"][i][valid][:, None].astype(np.float32)],
                                       axis=1)
                exchange_db.save(token, lid, "modar", modar)
            fg = None
            if cls_prob is not None:
                send = (cls_prob[i][:, 0] < bg_prob_thresh) & pmask[i]
                if send.any():
                    fg = np.concatenate([points[i][send][:, :7], cls_prob[i][send],
                                         flow[i][send]], axis=1)
                    exchange_db.save(token, lid, "foreground", fg)
            if modar is not None:
                exchange_db.save(token, lid, "boxflow", pool_box_flow(modar, fg))

    return writer
