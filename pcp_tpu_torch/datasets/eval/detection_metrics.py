"""nuScenes detection-protocol evaluation in numpy.

Counterpart of ``pcp_tpu/datasets/eval/detection_metrics.py``: the
``detection_cvpr_2019`` protocol keyed by lidar token, as the reference's
V2X-Sim evaluation:

  * per-class range filtering on GT and predictions by BEV distance from the
    sensor (the boxes are already in the lidar frame);
  * matching by BEV centre distance at {0.5, 1, 2, 4} m, greedy over the
    predictions in descending score over the whole dataset, each GT matched
    once;
  * AP: the normalised area of the 101-point interpolated precision/recall
    curve with min_recall = min_precision = 0.1;
  * TP errors at 2.0 m by the official recall-binned cumulative mean: ATE,
    ASE, AOE, and AVE / AAE only where predictions and GT both carry
    velocities / attributes (the NDS divisor counts the ones present);
  * mAP over classes x thresholds; NDS = (5 mAP + sum(1 - min(1, err))) /
    (5 + number of TP errors).
"""
import json
from pathlib import Path

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_PTS = 101

# detection_cvpr_2019 class_range (official eval config); classes not listed
# default to 50 m
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}


def _yaw_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _aligned_iou3d(box_a, box_b):
    """IoU of boxes translated to the origin with aligned yaw (official ASE)."""
    inter = np.prod(np.minimum(box_a[3:6], box_b[3:6]))
    union = np.prod(box_a[3:6]) + np.prod(box_b[3:6]) - inter
    return inter / max(union, 1e-6)


def _cummean(x):
    if len(x) == 0:
        return x
    return np.cumsum(x) / (np.arange(len(x)) + 1.0)


def _accumulate(pred_list, gt_by_token, class_name, dist_th):
    """One (class, threshold) accumulation over the whole dataset.

    pred_list: list of (score, token, box7[, velocity2]) for this class,
    UNSORTED and already range-filtered. Returns the official
    DetectionMetricData equivalent: 101-point precision/confidence curves and
    recall-binned TP error curves.
    """
    cls_range = CLASS_RANGE.get(class_name, 50.0)
    npos = 0
    for gt in gt_by_token.values():
        in_range = np.linalg.norm(gt["boxes"][:, :2], axis=1) <= cls_range
        npos += int(((gt["names"] == class_name) & in_range).sum())

    preds = sorted(pred_list, key=lambda e: -e[0])
    tp = np.zeros(len(preds))
    fp = np.zeros(len(preds))
    conf = np.asarray([p[0] for p in preds], dtype=np.float64)
    match_err = {"trans_err": [], "scale_err": [], "orient_err": [],
                 "vel_err": [], "attr_err": []}
    match_conf = []
    has_vel = has_attr = True

    taken = {tok: set() for tok in gt_by_token}
    for i, pred in enumerate(preds):
        score, token, box = pred[0], pred[1], pred[2]
        gt = gt_by_token.get(token)
        best_dist, best_j = np.inf, -1
        if gt is not None:
            cls_mask = gt["names"] == class_name
            in_range = np.linalg.norm(gt["boxes"][:, :2], axis=1) <= cls_range
            idxs = np.where(cls_mask & in_range)[0]
            for j in idxs:
                if j in taken[token]:
                    continue
                d = np.linalg.norm(gt["boxes"][j, :2] - box[:2])
                if d < best_dist:
                    best_dist, best_j = d, j
        if best_j >= 0 and best_dist < dist_th:
            taken[token].add(best_j)
            tp[i] = 1
            gt_box = gt_by_token[token]["boxes"][best_j]
            match_err["trans_err"].append(best_dist)
            match_err["scale_err"].append(1.0 - _aligned_iou3d(box, gt_box))
            match_err["orient_err"].append(_yaw_diff(box[6], gt_box[6]))
            gt_vel = gt_by_token[token].get("velocities")
            det_vel = pred[3] if len(pred) > 3 else None
            if gt_vel is not None and det_vel is not None:
                match_err["vel_err"].append(
                    float(np.linalg.norm(np.asarray(det_vel)[:2] - gt_vel[best_j][:2]))
                )
            else:
                has_vel = False
            gt_attr = gt_by_token[token].get("attributes")
            det_attr = pred[4] if len(pred) > 4 else None
            if gt_attr is not None and det_attr is not None:
                match_err["attr_err"].append(float(det_attr != gt_attr[best_j]))
            else:
                has_attr = False
            match_conf.append(score)
        else:
            fp[i] = 1

    # --- official interpolation onto the 101-point recall grid
    rec_interp = np.linspace(0, 1, N_RECALL_PTS)
    if npos == 0 or len(preds) == 0:
        return {
            "npos": npos,
            "precision": np.zeros(N_RECALL_PTS),
            "confidence": np.zeros(N_RECALL_PTS),
            "tp_curves": {},
            "any_tp": False,
        }
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / npos
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    prec_interp = np.interp(rec_interp, recall, precision, right=0)
    conf_interp = np.interp(rec_interp, recall, conf, right=0)

    tp_curves = {}
    if match_conf:
        mc = np.asarray(match_conf, dtype=np.float64)
        for key in ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err"):
            if key == "vel_err" and not has_vel:
                continue
            if key == "attr_err" and not has_attr:
                continue
            vals = np.asarray(match_err[key], dtype=np.float64)
            if len(vals) != len(mc):
                continue
            tmp = _cummean(vals)
            # map cummean errors onto the recall grid through the confidence
            # curve (official accumulate(): interp in descending confidence)
            tp_curves[key] = np.interp(conf_interp[::-1], mc[::-1], tmp[::-1])[::-1]
    return {
        "npos": npos,
        "precision": prec_interp,
        "confidence": conf_interp,
        "tp_curves": tp_curves,
        "any_tp": bool(match_conf),
    }


def _calc_ap(acc):
    """Official nuScenes calc_ap on the interpolated precision curve."""
    if acc["npos"] == 0:
        return np.nan
    prec = acc["precision"].copy()
    prec = prec[round(100 * MIN_RECALL) + 1 :]
    prec = prec - MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec) / (1.0 - MIN_PRECISION))


def _calc_tp(acc, metric):
    """Official nuScenes calc_tp: mean of the recall-binned error curve over
    (min_recall, max achieved recall]; 1.0 when no recall overlap."""
    curve = acc["tp_curves"].get(metric)
    if curve is None:
        return None
    nz = np.nonzero(acc["confidence"])[0]
    if len(nz) == 0:
        return 1.0
    last_ind = int(nz[-1])
    first_ind = round(100 * MIN_RECALL) + 1
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(curve[first_ind : last_ind + 1]))


_TP_NAME = {"trans_err": "ATE", "scale_err": "ASE", "orient_err": "AOE",
            "vel_err": "AVE", "attr_err": "AAE"}


def nuscenes_protocol_eval(det_annos, gt_by_token, class_names, output_path=None):
    """
    Args:
        det_annos: list of per-sample dicts with 'boxes_lidar' (N, 7+),
            'score' (N,), 'name' (N,), 'metadata' {'lidar_token': ...};
            optional 'velocity' (N, 2) / 'attribute' (N,).
        gt_by_token: {lidar_token: {'boxes': (M, 7), 'names': (M,)}};
            optional 'velocities' (M, 2) / 'attributes' (M,).
    Returns:
        (result_str, result_dict) like the reference dataset.evaluation.
    """
    preds_by_class = {c: [] for c in class_names}
    for anno in det_annos:
        token = anno["metadata"]["lidar_token"]
        vels = anno.get("velocity")
        attrs = anno.get("attribute")
        for k, (box, score, name) in enumerate(
            zip(anno["boxes_lidar"], anno["score"], anno["name"])
        ):
            if name not in preds_by_class:
                continue
            if np.linalg.norm(np.asarray(box[:2])) > CLASS_RANGE.get(name, 50.0):
                continue  # official per-class range filter on detections
            entry = [float(score), token, np.asarray(box[:7])]
            if vels is not None:
                entry.append(np.asarray(vels[k]))
                if attrs is not None:
                    entry.append(attrs[k])
            preds_by_class[name].append(tuple(entry))

    result_dict = {}
    ap_values = []
    tp_scores = []
    lines = []
    for cls in class_names:
        cls_aps = {}
        tp_errs = {}
        for th in DIST_THRESHOLDS:
            acc = _accumulate(preds_by_class[cls], gt_by_token, cls, th)
            cls_aps[th] = _calc_ap(acc)
            if th == TP_THRESHOLD:
                for key, label in _TP_NAME.items():
                    v = _calc_tp(acc, key)
                    if v is None and key in ("trans_err", "scale_err", "orient_err"):
                        v = 1.0  # no matches at all
                    if v is not None:
                        tp_errs[label] = v
        mean_ap_cls = float(np.nanmean([v for v in cls_aps.values()]))
        result_dict[f"{cls}_AP"] = mean_ap_cls
        for th, v in cls_aps.items():
            result_dict[f"{cls}_AP_dist_{th}"] = v
        result_dict.update({f"{cls}_{k}": v for k, v in tp_errs.items()})
        ap_values.append(mean_ap_cls)
        tp_scores.extend(1.0 - min(1.0, v) for v in tp_errs.values())
        lines.append(
            f"{cls}: AP {mean_ap_cls * 100:.2f} "
            + " ".join(f"AP@{th} {cls_aps[th] * 100:.2f}" for th in DIST_THRESHOLDS)
            + " | " + " ".join(f"{k} {v:.3f}" for k, v in tp_errs.items())
        )

    mean_ap = float(np.nanmean(ap_values)) if ap_values else 0.0
    nds = (5.0 * mean_ap + sum(tp_scores)) / (5.0 + len(tp_scores)) if tp_scores else mean_ap
    result_dict["mAP"] = mean_ap
    result_dict["NDS"] = nds
    # make the NDS divisor explicit: devkit NDS averages 5 TP metrics; when
    # velocity/attribute data is absent (7-DOF V2X boxes) only the available
    # ones enter, and the printed name says so — the number is NOT comparable
    # to a nuScenes-devkit NDS unless all five are listed
    tp_names = sorted({k.split("_", 1)[1] for k in result_dict
                       if any(k.endswith(s) for s in _TP_NAME.values())})
    n_cls = max(len(class_names), 1)
    nds_label = ("NDS" if len(tp_scores) == 5 * n_cls
                 else f"NDS[{','.join(tp_names) or 'mAP-only'}]")
    result_dict["NDS_tp_metrics"] = tp_names
    lines.append(f"mAP: {mean_ap * 100:.2f}  {nds_label}: {nds * 100:.2f}")
    result_str = "\n".join(lines)

    if output_path is not None:
        out = Path(output_path)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "metrics_summary.json", "w") as f:
            json.dump(result_dict, f, indent=2)
    return result_str, result_dict
