"""Evaluation loop and the exchange writer.

Counterpart of ``pcp_tpu/train/eval_utils.py``: ``eval_one_epoch`` runs the
model over a loader in eval mode, turns the fixed-shape outputs into
per-sample annotations (``generate_prediction_dicts``), counts the recall of
the gt at 3D-IoU thresholds and runs the dataset's evaluation (the
nuScenes-protocol mAP); ``make_exchange_writer`` broadcasts a sender's
outputs into the exchange database. Under a process group of several ranks
each rank runs its share of every batch; the predictions are merged in the
global order (``parallel.merge_results_dist``, the loader's padding left
out) and the recall counts summed before every rank evaluates the whole
set, rank 0 alone writing the evaluation's files.
"""
import time

import numpy as np
import torch

from ..exchange.database import pool_box_flow
from ..ops.rotated_iou import boxes_iou3d
from ..parallel.collective import all_gather_objects, get_dist_info, merge_results_dist
from .train_utils import AverageMeter, _to_device_batch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recall_counts(pred_boxes, pred_valid, gt_boxes, thresh_list):
    """[number of gt, gt recalled at each threshold] over the batch: a gt
    (a row of ``gt_boxes`` not all zero) is recalled when its best 3D IoU
    with a valid predicted box exceeds the threshold."""
    gt_valid = torch.any(gt_boxes[..., :7] != 0, dim=-1)
    iou = boxes_iou3d(gt_boxes[..., :7], pred_boxes[..., :7])  # (B, G, P)
    iou = torch.where(pred_valid[:, None, :], iou, 0.0)
    best = iou.max(dim=2).values if iou.shape[2] else torch.zeros_like(gt_valid, dtype=iou.dtype)
    counts = [gt_valid.sum()] + [((best > th) & gt_valid).sum() for th in thresh_list]
    return torch.stack(counts).cpu().numpy()


def _forward(model, batch, meter=None):
    """The model's forward; with ``meter``, its time goes into it: between
    CUDA events on the card, on the host clock on the CPU."""
    if meter is None:
        return model(batch)
    if batch["points"].device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = model(batch)
        end.record()
        end.synchronize()
        meter.update(start.elapsed_time(end) / 1e3)
        return out
    t_inf = time.perf_counter()
    out = model(batch)
    meter.update(time.perf_counter() - t_inf)
    return out


def eval_one_epoch(model, dataset, dataloader, class_names, logger=None,
                   recall_thresh_list=(0.3, 0.5, 0.7), output_path=None, exchange_writer=None,
                   infer_time=False):
    """Returns (result_str, result_dict, det_annos). ``infer_time``: the
    forward's time a batch, between CUDA events on the card (the host clock
    on the CPU), the first two batches left out. A host model
    (``is_host_model``: late fusion) takes the loader's batch as it is, on
    the host, and is not timed."""
    host_model = getattr(model, "is_host_model", False)
    if not host_model:
        model.eval()
        device = next(model.parameters()).device
    rank, world = get_dist_info()
    det_annos, chunk = [], 1
    recall_acc = np.zeros(1 + len(recall_thresh_list))
    infer_meter = AverageMeter() if infer_time else None
    warmup = 2
    t0 = time.time()
    with torch.inference_mode():
        for i_batch, batch in enumerate(dataloader):
            if host_model:
                out, dev_batch = model(batch), batch
            else:
                dev_batch = _to_device_batch(batch, device)
                timed = infer_time and i_batch >= warmup
                out = _forward(model, dev_batch, infer_meter if timed else None)
            fbd = {k: _np(v) for k, v in out["final_box_dicts"].items()}
            det_annos.extend(dataset.generate_prediction_dicts(batch, fbd, class_names))
            chunk = len(batch["points"])
            if "gt_boxes" in dev_batch:
                fb = out["final_box_dicts"]
                # the loader's padding (global position past the dataset) is not counted
                first = (i_batch * world + rank) * chunk
                real = max(0, min(chunk, len(dataset) - first))
                recall_acc += _recall_counts(torch.as_tensor(fb["pred_boxes"])[:real],
                                             torch.as_tensor(fb["pred_valid"])[:real],
                                             torch.as_tensor(dev_batch["gt_boxes"])[:real],
                                             list(recall_thresh_list))
            if exchange_writer is not None:
                exchange_writer(batch, out)

    if world > 1:
        det_annos = merge_results_dist(det_annos, len(dataset), chunk)
        recall_acc = np.sum(all_gather_objects(recall_acc), axis=0)
    n_samples = len(det_annos)
    sec_per_example = (time.time() - t0) / max(n_samples, 1)
    if logger is not None:
        logger.info(f"eval: {n_samples} samples, {sec_per_example:.4f} s/sample")
        if infer_meter is not None and infer_meter.count:
            logger.info(f"infer_time: {infer_meter.avg * 1e3:.3f} ms/batch "
                        f"({int(infer_meter.count)} batches)")

    result_dict = {}
    num_gt = max(recall_acc[0], 1)
    for i, th in enumerate(recall_thresh_list):
        result_dict[f"recall/rcnn_{th}"] = recall_acc[1 + i] / num_gt
    result_str, metrics = dataset.evaluation(det_annos, class_names, eval_metric="nuscenes",
                                             output_path=output_path if rank == 0 else None)
    result_dict.update(metrics)
    result_dict["sec_per_example"] = sec_per_example
    if infer_meter is not None and infer_meter.count:
        result_dict["infer_time_ms_per_batch"] = infer_meter.avg * 1e3
    return result_str, result_dict, det_annos


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
