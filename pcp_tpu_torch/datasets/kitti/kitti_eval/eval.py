"""Official KITTI object-detection evaluation (AP11 / AP-R40, bbox, bev, 3d,
aos): counterpart of ``pcp_tpu/datasets/kitti/kitti_eval/eval.py``.

Per class and difficulty AP over 41 recall points, greedy TP assignment
with ignored and DontCare handling, and the threshold-subsampling rule of
the official numba code, in plain python loops over the small per-frame
(dt x gt) matrices. The rotated overlaps come from the port's
``ops/rotated_iou.py`` on CPU tensors in float32, as the JAX package takes
them from its own on the host in float32: camera-frame (x, z, w, l, ry)
rectangles map onto the same rotated-rectangle geometry.
"""
import io as sysio

import numpy as np


# ---------------------------------------------------------------- thresholds
def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds hitting about 41 recall points."""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
                i < (len(scores) - 1)):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


CLASS_NAMES_KITTI = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'truck']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno, dt_anno, current_class, difficulty, class_names):
    """Difficulty, neighbour-class and DontCare filtering of one frame."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = class_names[current_class].lower()
    num_gt = len(gt_anno["name"])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


# ----------------------------------------------------------------- overlaps
def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Image-box overlaps, boxes (N, 4) against query (K, 4)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_n = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_k = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_n + area_k - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_n, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_k, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def _rotated_overlap_area(boxes, qboxes):
    """Intersection areas of camera-frame rotated rects (x, z, w, l, ry)."""
    import torch

    from ....ops.rotated_iou import boxes_overlap_bev

    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))

    def to7(b):
        return torch.from_numpy(np.concatenate(
            [b[:, 0:1], b[:, 1:2], np.zeros((b.shape[0], 1)), b[:, 2:3], b[:, 3:4],
             np.ones((b.shape[0], 1)), b[:, 4:5]], axis=1).astype(np.float32))

    return boxes_overlap_bev(to7(boxes), to7(qboxes)).numpy().astype(np.float64)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """BEV overlaps under the criterion of the official rotated IoU."""
    inter = _rotated_overlap_area(boxes, qboxes)
    area_n = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_k = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        return inter / np.maximum(area_n + area_k - inter, 1e-12)
    if criterion == 0:
        return inter / np.maximum(area_n, 1e-12)
    if criterion == 1:
        return inter / np.maximum(area_k, 1e-12)
    return inter


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D overlaps (camera coords: y is down, h along -y)."""
    rinc = bev_box_overlap(boxes[:, [0, 2, 3, 5, 6]],
                           qboxes[:, [0, 2, 3, 5, 6]], criterion=2)
    n, k = rinc.shape
    if n == 0 or k == 0:
        return rinc
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    area1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    area2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.where(iw > 0, iw * rinc, 0.0)
    if criterion == -1:
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(area1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area2, inc.shape)
    else:
        ua = np.ones_like(inc)
    return np.where((rinc > 0) & (iw > 0), inc / ua, 0.0)


# --------------------------------------------------------------- statistics
NO_DETECTION = -10000000


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """TP, FP, FN, similarity and thresholds of one frame; overlaps
    (num_dt, num_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    tp, fp, fn, similarity = 0, 0, 0, 0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp) and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1)
                    or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [0.0] * fp + [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = np.sum(tmp) if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, np.array(thresholds)


def _prepare_data(gt_annos, dt_annos, current_class, difficulty, class_names):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty, class_names)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(np.stack(dc_bboxes, 0).astype(np.float64)
                         if dc_bboxes else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt_annos[i]["bbox"], gt_annos[i]["alpha"][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt_annos[i]["bbox"], dt_annos[i]["alpha"][..., None],
             dt_annos[i]["score"][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def calculate_iou(gt_annos, dt_annos, metric):
    """Per-frame (num_dt, num_gt) overlap matrices."""

    def frame_boxes(a):
        if metric == 0:
            return a["bbox"]
        if metric == 1:
            return np.concatenate(
                [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                 a["rotation_y"][..., None]], axis=1)
        return np.concatenate(
            [a["location"], a["dimensions"], a["rotation_y"][..., None]], axis=1)

    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        g, d = frame_boxes(gt), frame_boxes(dt)
        if metric == 0:
            overlaps.append(image_box_overlap(d, g))
        elif metric == 1:
            overlaps.append(bev_box_overlap(d, g).astype(np.float64))
        else:
            overlaps.append(d3_box_overlap(d, g).astype(np.float64))
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, class_names=None):
    """Precision, recall and orientation similarity per class, difficulty and
    minimum overlap."""
    assert len(gt_annos) == len(dt_annos)
    class_names = class_names or CLASS_NAMES_KITTI
    overlaps = calculate_iou(gt_annos, dt_annos, metric)
    n_sample_pts = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, n_sample_pts])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
             total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty, class_names)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = compute_statistics(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap, compute_fp=False)
                    thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    for t, thr in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=thr,
                            compute_fp=True, compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if sim != -1:
                            pr[t, 3] += sim
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, PR_detail_dict=None, class_names=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos, class_names=class_names)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    if PR_detail_dict is not None:
        PR_detail_dict["bbox"] = ret["precision"]
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
        if PR_detail_dict is not None:
            PR_detail_dict["aos"] = ret["orientation"]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, class_names=class_names)
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    if PR_detail_dict is not None:
        PR_detail_dict["bev"] = ret["precision"]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, class_names=class_names)
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    if PR_detail_dict is not None:
        PR_detail_dict["3d"] = ret["precision"]
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    """The AP table as text and the R40 results as a dict (KITTI class set)."""
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                     4: "Person_sitting", 5: "Truck"}
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    name_to_class = {v.lower(): n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c.lower()] if isinstance(c, str) else int(c)
        for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]
    class_names = [class_to_name[i].lower() for i in range(6)]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           compute_aos, PR_detail_dict, class_names=class_names)

    result = ""
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        name = class_to_name[curcls]
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                f"{name} AP@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:")
            result += print_str(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, {mAPbbox[j, 2, i]:.4f}")
            result += print_str(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, {mAPbev[j, 2, i]:.4f}")
            result += print_str(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, {mAP3d[j, 2, i]:.4f}")
            result += print_str(
                f"bbox AP_R40:{mAPbbox_R40[j, 0, i]:.4f}, {mAPbbox_R40[j, 1, i]:.4f}, {mAPbbox_R40[j, 2, i]:.4f}")
            result += print_str(
                f"bev  AP_R40:{mAPbev_R40[j, 0, i]:.4f}, {mAPbev_R40[j, 1, i]:.4f}, {mAPbev_R40[j, 2, i]:.4f}")
            result += print_str(
                f"3d   AP_R40:{mAP3d_R40[j, 0, i]:.4f}, {mAP3d_R40[j, 1, i]:.4f}, {mAP3d_R40[j, 2, i]:.4f}")
            if compute_aos:
                result += print_str(
                    f"aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, {mAPaos[j, 2, i]:.2f}")
                result += print_str(
                    f"aos  AP_R40:{mAPaos_R40[j, 0, i]:.2f}, {mAPaos_R40[j, 1, i]:.2f}, {mAPaos_R40[j, 2, i]:.2f}")
            if i == 0:
                for d, diff in enumerate(("easy", "moderate", "hard")):
                    ret_dict[f"{name}_3d/{diff}_R40"] = mAP3d_R40[j, d, 0]
                    ret_dict[f"{name}_bev/{diff}_R40"] = mAPbev_R40[j, d, 0]
                    ret_dict[f"{name}_image/{diff}_R40"] = mAPbbox_R40[j, d, 0]
                    if compute_aos:
                        ret_dict[f"{name}_aos/{diff}_R40"] = mAPaos_R40[j, d, 0]
    return result, ret_dict
