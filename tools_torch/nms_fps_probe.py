"""Two costs of the port's plain-torch detector paths, measured on the card.

1. The rotated NMS's overlap matrix (``pcp_tpu_torch/ops/nms.py``), two
   ways: dense, the (K, K) rotated IoU of every pair, and pair-restricted,
   the IoU only of the pairs whose circumscribed BEV circles meet. Both on
   the candidates that the models' own forwards hand to the NMS (the
   anchor car b4 x 65536, the JR nomap model b4 x 262144 with its six heads,
   PointRCNN b2 x 16384 with its 9000 proposals and its final NMS; seeded
   weights, chip_smoke's inputs) and on synthetic sets of K candidates
   clustered about 40 objects, as a trained detector's are. For each: the
   kept decisions of both equal, the pairs that meet, the milliseconds of
   each (median of CUDA-event timings).
2. PointRCNN's farthest point sampling (``ops/pointnet2.py``), whose squared
   distances emulate XLA's fused multiply-adds (float64 casts, one rounding):
   the card's launches a sequential step, from one traced run of
   ``torch.profiler``, and the time of 16384 -> 4096 at b2, against the
   same loop with plain float32 products and sums; ball query's squared
   distances at (2, 4096, 16384), time and peak memory, both ways.

    python3 tools_torch/nms_fps_probe.py [--seed 0] [--out build/nms_fps_probe.json]

Prints one line per reading and writes all of them as JSON to ``--out``.
Needs a CUDA device.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

SYN_OBJECTS = 40


def dense_over(boxes, thresh):
    from pcp_tpu_torch.ops import nms

    return nms._over_dense(boxes, thresh)


def pair_over(boxes, thresh):
    from pcp_tpu_torch.ops import nms

    return nms._over_pairs(boxes, thresh)


def meeting_pairs(boxes):
    r = 0.5 * torch.sqrt(boxes[..., 3] ** 2 + boxes[..., 4] ** 2)
    d2 = ((boxes[..., :, None, 0] - boxes[..., None, :, 0]) ** 2
          + (boxes[..., :, None, 1] - boxes[..., None, :, 1]) ** 2)
    reach = (r[..., :, None] + r[..., None, :]) * 1.001 + 1e-3
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    return int(((d2 <= reach * reach) & (idx[None, :] < idx[:, None])).sum())


def keep_of(over, valid):
    over = over & valid[..., None, :]
    keep = valid
    while True:
        new_keep = valid & ~(over & keep[..., None, :]).any(-1)
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def compare(what, boxes, valid, thresh):
    """Both overlap paths on one NMS call's sorted candidates."""
    b, k = valid.shape[0] if valid.dim() > 1 else 1, boxes.shape[-2]
    rec = {"what": what, "batch": b, "candidates": k, "valid": int(valid.sum()),
           "thresh": thresh, "meeting_pairs": meeting_pairs(boxes),
           "all_pairs": b * k * (k - 1) // 2}
    with torch.no_grad():
        pairs = pair_over(boxes, thresh)
        rec["pairs_ms"] = cs.cuda_ms(lambda: pair_over(boxes, thresh), warmup=1, iters=5)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            dense = dense_over(boxes, thresh)
            rec["dense_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            rec["dense_ms"] = cs.cuda_ms(lambda: dense_over(boxes, thresh), warmup=1, iters=5)
            rec["equal_keep"] = bool(torch.equal(keep_of(dense, valid), keep_of(pairs, valid)))
            del dense
        except torch.cuda.OutOfMemoryError:
            rec["dense_ms"], rec["equal_keep"] = "out of memory", None
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pair_over(boxes, thresh)
        rec["pairs_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    cs.log("probe", json.dumps(rec))
    return rec


def captured(model, batch):
    """Every (sorted boxes, valid, thresh) that a forward hands the NMS."""
    from pcp_tpu_torch.ops import nms

    seen, orig = [], nms._greedy_suppress

    def record(boxes, valid, thresh):
        seen.append((boxes.clone(), valid.clone(), float(thresh)))
        return orig(boxes, valid, thresh)

    nms._greedy_suppress = record
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        nms._greedy_suppress = orig
    return seen


def model_candidates(seed):
    from pcp_tpu_torch.entry import CFG_POINTRCNN, build

    out = []
    cfg, info, model = build(cs.A11_MODELS[0][1], device="cuda")
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    rng = np.random.default_rng(seed + 20)
    pts = cs.realistic_points(rng, b, cs.SENDER_N, info.num_point_features)
    batch = cs._on({"points": torch.from_numpy(pts),
                    "points_mask": torch.ones((b, cs.SENDER_N), dtype=torch.bool)}, "cuda")
    sd = cs.seeded_state_dict(model, seed)
    model.load_state_dict(sd, strict=True)
    cs.balance_anchor_bias(model, sd, batch, float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH))
    out += [("anchor_car", *c) for c in captured(model, batch)]
    del model, batch

    cfg, info, model = build(cs.JR_CFGS / f"{cs.JR_MODELS[0]}.yaml", device="cuda")
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    rng = np.random.default_rng(seed + 30)
    batch = cs._on({"points": torch.from_numpy(cs.jr_points(rng, b, cs.JR_N, info.num_point_features)),
                    "points_mask": torch.ones((b, cs.JR_N), dtype=torch.bool)}, "cuda")
    cs.jr_seeded(model, seed)
    out += [(f"jr_nomap head {i}", *c) for i, c in enumerate(captured(model, batch))]
    del model, batch

    cfg, info, model = build(CFG_POINTRCNN, device="cuda")
    b, n = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU), 16384
    rng = np.random.default_rng(seed + 40)
    lo, hi = np.array(info.point_cloud_range[:3]), np.array(info.point_cloud_range[3:])
    pts = np.concatenate([rng.uniform(lo, hi, (b, n, 3)), rng.uniform(0, 1, (b, n, 1))], -1)
    batch = cs._on({"points": torch.from_numpy(pts.astype(np.float32)),
                    "points_mask": torch.ones((b, n), dtype=torch.bool)}, "cuda")
    model.load_state_dict(cs.seeded_state_dict(model, seed), strict=True)
    names = iter(("pointrcnn proposals", "pointrcnn final"))
    out += [(next(names), *c) for c in captured(model, batch)]
    del model, batch
    torch.cuda.empty_cache()
    return out


def synthetic(rng, b, k, spread):
    """K candidates a sample about SYN_OBJECTS car-sized objects, sorted by
    a random score: ``spread`` metres of centre jitter, 10% on the sizes."""
    centres = rng.uniform([0, -40], [70, 40], (b, SYN_OBJECTS, 2))
    owner = rng.integers(0, SYN_OBJECTS, (b, k))
    xy = np.take_along_axis(centres, owner[..., None].repeat(2, -1), 1) + rng.normal(0, spread, (b, k, 2))
    size = np.array([3.9, 1.6, 1.56]) * rng.uniform(0.9, 1.1, (b, k, 3))
    boxes = np.concatenate([xy, rng.uniform(-2, 0, (b, k, 1)), size,
                            rng.uniform(-np.pi, np.pi, (b, k, 1))], -1).astype(np.float32)
    return torch.from_numpy(boxes).cuda(), torch.ones((b, k), dtype=torch.bool, device="cuda")


def fps_plain(xyz, npoint):
    """``farthest_point_sample`` with plain float32 products and sums."""
    b, n, _ = xyz.shape
    mind2 = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    last = idx[:, 0]
    rows = torch.arange(b, device=xyz.device)
    for k in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        mind2 = torch.minimum(mind2, d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                              + d[..., 2] * d[..., 2])
        last = torch.argmax(mind2, dim=-1)
        idx[:, k] = last
    return idx


def sqdist_plain(a, b):
    def dot(x, y):
        return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]
    return torch.clamp(dot(a, a)[..., :, None] + dot(b, b)[..., None, :]
                       - 2.0 * dot(a[..., :, None, :], b[..., None, :, :]), min=0.0)


def device_launches(fn):
    """Kernels and copies on the card in one traced call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def fps_probe(seed):
    from pcp_tpu_torch.ops import pointnet2 as pn2

    rng = np.random.default_rng(seed + 50)
    b, n = 2, 16384
    xyz = torch.from_numpy(rng.uniform([0, -40, -3], [70.4, 40, 1], (b, n, 3)).astype(np.float32)).cuda()
    rec = {}
    for name, fn in (("emulated", pn2.farthest_point_sample), ("plain", fps_plain)):
        fn(xyz, 8)
        first = device_launches(lambda: fn(xyz, 1))
        many = device_launches(lambda: fn(xyz, 65))
        rec[name] = {"launches_a_step": (many - first) / 64, "launches_outside_the_loop": first,
                     "ms_4096_of_16384": cs.cuda_ms(lambda: fn(xyz, 4096), warmup=1, iters=3)}
    rec["indices_equal_4096"] = bool(torch.equal(pn2.farthest_point_sample(xyz, 4096),
                                                 fps_plain(xyz, 4096)))
    new = xyz[:, :4096].contiguous()
    for name, fn in (("emulated", pn2.square_distance), ("plain", sqdist_plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(new, xyz)
        torch.cuda.synchronize()
        rec[f"square_distance_{name}"] = {
            "shape": list(out.shape), "peak_bytes_above_inputs": torch.cuda.max_memory_allocated() - base,
            "ms": cs.cuda_ms(lambda: fn(new, xyz), warmup=1, iters=5),
            "launches": device_launches(lambda: fn(new, xyz))}
        del out
    torch.cuda.empty_cache()
    cs.log("probe", "fps " + json.dumps(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/nms_fps_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_fps_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    record = {"card": card, "models": [], "synthetic": []}
    for what, boxes, valid, thresh in model_candidates(args.seed):
        record["models"].append(compare(what, boxes, valid, thresh))
    rng = np.random.default_rng(args.seed + 60)
    for b, k in ((4, 512), (4, 1000), (4, 2048), (4, 4096), (2, 9000)):
        for spread in (0.5, 3.0):
            for thresh in (0.2, 0.8):
                boxes, valid = synthetic(rng, b, k, spread)
                record["synthetic"].append(compare(f"synthetic spread {spread}", boxes, valid, thresh))
    record["fps"] = fps_probe(args.seed)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
