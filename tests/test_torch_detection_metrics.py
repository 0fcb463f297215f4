"""The port's nuScenes-protocol evaluation against the JAX package's.

Each case (those of tests/test_detection_metrics.py, merged where they
repeat each other, and a seeded random one with both classes, velocities and
far boxes) goes through ``nuscenes_protocol_eval`` of both packages; the
result dicts must agree to 1e-12 key for key (NaN where the other is NaN)
and the result strings exactly.
"""
import numpy as np
import pytest

from pcp_tpu.datasets.eval.detection_metrics import nuscenes_protocol_eval as jax_eval
from pcp_tpu_torch.datasets.eval.detection_metrics import nuscenes_protocol_eval as torch_eval


def _box(x, y, yaw=0.0, dims=(4.0, 2.0, 1.6), z=0.0):
    return np.array([x, y, z, *dims, yaw], dtype=np.float64)


def _gt(boxes, names, **extra):
    return {"boxes": np.asarray(boxes, dtype=np.float64).reshape(-1, 7),
            "names": np.asarray(names), **extra}


def _anno(token, boxes, scores, names, **extra):
    return {"metadata": {"lidar_token": token},
            "boxes_lidar": np.asarray(boxes, dtype=np.float64).reshape(-1, 7),
            "score": np.asarray(scores, dtype=np.float64), "name": np.asarray(names), **extra}


def case_oracle():
    rng = np.random.default_rng(0)
    gt, det = {}, []
    for t in range(4):
        boxes = np.stack([_box(x, y, yaw) for x, y, yaw in zip(
            rng.uniform(-40, 40, 5), rng.uniform(-30, 30, 5), rng.uniform(-3, 3, 5))])
        gt[f"tok{t}"] = _gt(boxes, ["car"] * 5)
        det.append(_anno(f"tok{t}", boxes, rng.uniform(0.5, 1.0, 5), ["car"] * 5))
    return det, gt, ["car"]


def case_half_recall():
    return ([_anno("t", [_box(0, 0)], [0.9], ["car"])],
            {"t": _gt([_box(0, 0), _box(10, 0)], ["car", "car"])}, ["car"])


def case_fp_before_tp():
    return ([_anno("t", [_box(30, 30), _box(0, 0)], [0.9, 0.8], ["car", "car"])],
            {"t": _gt([_box(0, 0)], ["car"])}, ["car"])


def case_no_predictions():
    return [], {"t": _gt([_box(0, 0)], ["car"])}, ["car"]


def case_range_filters():
    """A car gt and prediction at 60 m (outside 50 m) and a pedestrian at
    45 m (outside 40 m: its AP is NaN)."""
    ped = (0.6, 0.6, 1.7)
    gt = {"t": _gt([_box(0, 0), _box(60, 0), _box(45, 0, dims=ped)],
                   ["car", "car", "pedestrian"])}
    det = [_anno("t", [_box(0, 0), _box(60, 0), _box(45, 0, dims=ped)], [0.9, 0.8, 0.9],
                 ["car", "car", "pedestrian"])]
    return det, gt, ["car", "pedestrian"]


def case_recall_binned_cummean():
    offsets = [0.1, 0.2, 0.3, 0.4, 0.5]
    gt = {"t": _gt([_box(5 * i, 0) for i in range(10)], ["car"] * 10)}
    det = [_anno("t", [_box(5 * i + offsets[i], 0) for i in range(5)],
                 [0.9, 0.8, 0.7, 0.6, 0.5], ["car"] * 5)]
    return det, gt, ["car"]


def case_velocities():
    boxes = [_box(0, 0)]
    return ([_anno("t", boxes, [0.9], ["car"], velocity=np.array([[1.5, 0.0]]))],
            {"t": _gt(boxes, ["car"], velocities=np.array([[1.0, 0.0]]))}, ["car"])


def case_random():
    """Two classes over six tokens: jittered, missed, duplicated and spurious
    detections with tied and untied scores, some out of range."""
    rng = np.random.default_rng(3)
    gt, det = {}, []
    for t in range(6):
        n = int(rng.integers(3, 12))
        names = rng.choice(["car", "pedestrian"], n, p=[0.7, 0.3])
        boxes = np.stack([_box(*rng.uniform(-55, 55, 2), rng.uniform(-3, 3)) for _ in range(n)])
        gt[f"tok{t}"] = _gt(boxes, names, velocities=rng.normal(0, 2, (n, 2)))
        keep = rng.uniform(size=n) < 0.8
        pred = boxes[keep] + rng.normal(0, 0.6, (keep.sum(), 7)) * [1, 1, 0.1, 0.1, 0.1, 0.1, 0.3]
        extra = np.stack([_box(*rng.uniform(-50, 50, 2)) for _ in range(3)])
        pred = np.concatenate([pred, pred[:1], extra])
        pnames = np.concatenate([names[keep], names[keep][:1], ["car"] * 3])
        scores = np.round(rng.uniform(0.1, 1.0, pred.shape[0]), 1)  # ties
        det.append(_anno(f"tok{t}", pred, scores, pnames,
                         velocity=rng.normal(0, 2, (pred.shape[0], 2))))
    return det, gt, ["car", "pedestrian"]


CASES = [case_oracle, case_half_recall, case_fp_before_tp, case_no_predictions,
         case_range_filters, case_recall_binned_cummean, case_velocities, case_random]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_nuscenes_protocol_eval_matches_jax(case, tmp_path):
    det, gt, classes = case()
    want_str, want = jax_eval(det, gt, classes)
    got_str, got = torch_eval(det, gt, classes, output_path=tmp_path)
    assert (tmp_path / "metrics_summary.json").exists()
    assert got_str == want_str
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), key
        elif isinstance(w, (float, int, np.floating)):
            assert abs(g - w) <= 1e-12, (key, g, w)
        else:
            assert g == w, key
