"""Benchmark of the port: the flagship lately-fusion ego's inference on one
NVIDIA GPU, with the trained checkpoint.

    python -m pcp_tpu_torch.bench [--bf16] [--pre-reduce {1,fused}] [--fold-bn] [--wpack]
        [--occupancy {realistic,clustered}] [--ckpt PATH|none]

The counterpart of the repository's ``bench.py`` for the port. The ego
(``v2x_pointpillar_basic_ego.yaml``) at full width loads
``results/bench_ckpt_torch.pt`` (the trained orbax checkpoint
``results/bench_ckpt`` exported by ``tests/torch_export_bench_ckpt.py``)
with ``strict=True``. Inputs are ``bench.py``'s "realistic" occupancy:
``np.random.default_rng(0)``, ITERS distinct batches of b8 x 32768 points,
4096 pillar centres a cloud. The batches are dispatched back to back and
timed with CUDA events, best of REPS; the result is one JSON line in
``bench.py``'s form (``metric``, ``value``, ``unit``) with the card's name
and power limit beside it and the modes it ran under ``modes``. TF32 is
off, as in every parity check of the port.

The flags are ``bench.py``'s environment switches (``bench.py:50-132``):
``--bf16`` (``BENCH_BF16``: ``MODEL.BF16``, the backbone and head serve in
bfloat16), ``--pre-reduce`` (``BENCH_PRE_REDUCE``: ``1`` the tails kernel
after the segmented max-scan, ``fused`` the fused kernel), ``--fold-bn``
(``BENCH_FOLD_BN``: the backbone's BNs folded into its convs at load),
``--wpack`` (``BENCH_WPACK``: the narrow level width-packed at load, after
any fold), ``--occupancy`` (``BENCH_OCCUPANCY``, draw for draw) and
``--ckpt`` (``BENCH_CKPT``; ``none`` takes weights made from a seeded
generator, ``train/train_state.py::init_weights``). With no flag it runs as
it did before they existed.

Earlier lines hold one ``torch.profiler`` trace each of a b8 and a b4
forward (CUDA activity, after warm-up): the device operations that take the
most time, the device's idle share of the traced window, and the longest
gaps between device operations with the host operation that ran meanwhile;
and the backbone's time at b8 and b4 with cuDNN's heuristic, with its
autotuner (``torch.backends.cudnn.benchmark``) and as two halves of the
batch.
"""
import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .config import ROOT_DIR
from .entry import CFG_EGO, build
from .models.backbones_2d.base_bev_backbone import fold_bn_state_dict, w_pack_state_dict
from .ops import bev_scatter
from .train.train_state import init_weights

CKPT = ROOT_DIR / "results" / "bench_ckpt_torch.pt"
BATCH, NPOINTS, ITERS, REPS = 8, 32768, 32, 3
N_PILLARS = 4096
N_CLUSTERS = 64  # the "clustered" occupancy's object clusters a cloud
SEED = 0  # of the weights under --ckpt none
# device activity in a Chrome trace of torch.profiler
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench_forward"  # the annotation around a traced forward


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true",
                    help="MODEL.BF16: the backbone and the head serve in bfloat16")
    ap.add_argument("--pre-reduce", choices=("1", "fused"), default=None,
                    help="MODEL.VFE.PRE_REDUCE: 1 = the tails kernel after the segmented "
                         "max-scan, fused = the fused kernel (default: unset)")
    ap.add_argument("--fold-bn", action="store_true",
                    help="fold the backbone's BNs into its convs at load (FOLD_BN)")
    ap.add_argument("--wpack", action="store_true",
                    help="width-pack the backbone's narrow level at load, after any fold "
                         "(W_PACK)")
    ap.add_argument("--occupancy", choices=("realistic", "clustered"), default="realistic")
    ap.add_argument("--ckpt", default=str(CKPT),
                    help="the ego's state dict, or 'none' for weights from a seeded generator")
    return ap.parse_args(argv)


def modes(args):
    """The modes ``args`` names, as the result line lists them."""
    return {"bf16": args.bf16, "pre_reduce": args.pre_reduce, "fold_bn": args.fold_bn,
            "wpack": args.wpack, "occupancy": args.occupancy, "ckpt": args.ckpt}


def load_trained_ego(device="cuda", args=None):
    """(cfg, info, model): the ego on ``device`` in eval mode, built in the
    modes of ``args`` (``parse_args``; by default none), holding the
    checkpoint ``args.ckpt`` (the trained one by default) or seeded weights,
    folded and packed at load as the modes ask."""
    args = args or parse_args([])
    set_cfgs = []
    if args.bf16:
        set_cfgs += ["MODEL.BF16", "True"]
    if args.fold_bn:
        set_cfgs += ["MODEL.BACKBONE_2D.FOLD_BN", "True"]
    if args.wpack:
        set_cfgs += ["MODEL.BACKBONE_2D.W_PACK", "True"]
    pre_reduce = {None: None, "1": True, "fused": "fused"}[args.pre_reduce]
    cfg, info, model = build(CFG_EGO, device=device, pre_reduce=pre_reduce, set_cfgs=set_cfgs)
    if args.ckpt == "none":
        _, _, plain = build(CFG_EGO, device="cpu")
        init_weights(plain, SEED)
        sd = plain.state_dict()
    else:
        sd = torch.load(args.ckpt, map_location=device, weights_only=True)
    if args.fold_bn:
        sd = fold_bn_state_dict(sd, cfg.MODEL.BACKBONE_2D)
    if args.wpack:
        sd = w_pack_state_dict(sd, cfg.MODEL.BACKBONE_2D)
    model.load_state_dict(sd, strict=True)
    return cfg, info, model.eval()


def realistic_inputs(num_features, iters=ITERS, batch=BATCH, npoints=NPOINTS, seed=0):
    """``bench.py``'s "realistic" occupancy, draw for draw: (iters, batch,
    npoints, num_features) float32, every point within 0.1 m of one of
    N_PILLARS random pillar centres of its cloud."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((iters, batch, npoints, num_features), dtype=np.float32)
    centers = rng.uniform(-50, 50, size=(iters, batch, N_PILLARS, 2))
    idx = rng.integers(0, N_PILLARS, size=npoints)
    pts[..., 0:2] = centers[:, :, idx, :] + rng.uniform(-0.1, 0.1, size=(iters, batch, npoints, 2))
    pts[..., 2] = rng.uniform(-3.0, -0.5, size=(iters, batch, npoints))
    pts[..., 3] = rng.uniform(0, 1, size=(iters, batch, npoints))
    return pts


def clustered_inputs(num_features, iters=ITERS, batch=BATCH, npoints=NPOINTS, seed=0):
    """``bench.py``'s "clustered" occupancy, draw for draw: every point
    spread N(0, 3 m) around one of N_CLUSTERS random centres of its cloud."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((iters, batch, npoints, num_features), dtype=np.float32)
    centers = rng.uniform(-45, 45, size=(iters, batch, N_CLUSTERS, 2))
    idx = rng.integers(0, N_CLUSTERS, size=npoints)
    pts[..., 0:2] = centers[:, :, idx, :] + rng.normal(0, 3.0, size=(iters, batch, npoints, 2))
    pts[..., 2] = rng.uniform(-3.0, -0.5, size=(iters, batch, npoints))
    pts[..., 3] = rng.uniform(0, 1, size=(iters, batch, npoints))
    return pts


def bench_batches(occupancy, num_features):
    """The ITERS batches of the bench, on the card."""
    draw = {"realistic": realistic_inputs, "clustered": clustered_inputs}[occupancy]
    mask = torch.ones((BATCH, NPOINTS), dtype=torch.bool, device="cuda")
    return [{"points": torch.from_numpy(p).cuda(), "points_mask": mask}
            for p in draw(num_features)]


def time_batches(model, batches, reps=REPS):
    """Milliseconds a batch: ``batches`` dispatched back to back between two
    CUDA events, the best of ``reps`` passes, after one warm-up forward."""
    with torch.inference_mode():
        model(batches[0])
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for b in batches:
                model(b)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
    return best / len(batches)


def trace(fn):
    """A ``torch.profiler`` trace (CPU and CUDA activity) of ``fn()``, as
    the parsed Chrome trace. The call runs inside a ``WINDOW`` annotation
    that ends after a synchronize, so the window holds all its device
    work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())


def trace_forward(model, batch, warmup=3):
    """``trace`` of one inference forward after ``warmup`` untraced ones."""
    with torch.inference_mode():
        for _ in range(warmup):
            model(batch)
        torch.cuda.synchronize()
        return trace(lambda: model(batch))


def trace_summary(chrome_trace, top=10, gaps=5):
    """From a Chrome trace with one ``WINDOW`` annotation: the ``top`` device
    operations by total time (name, calls, ms), the device's busy time and
    idle share of the window, and the ``gaps`` longest gaps between device
    operations inside it, each with the operations before and after it and
    the innermost host operation running at its middle."""
    events = [e for e in chrome_trace["traceEvents"] if e.get("ph") == "X"]
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise ValueError(f"expected one {WINDOW!r} annotation in the trace, found {len(window)}")
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES
                     and t0 <= float(e["ts"]) < t1), key=lambda e: float(e["ts"]))
    by_name = {}
    for e in device:
        calls, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (calls + 1, us + float(e["dur"]))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]

    busy, holes, end, last = 0.0, [], t0, None
    for e in device:  # the union of device intervals, and the holes in it
        s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if s > end:
            holes.append((s - end, end, last, e["name"]))
        busy += max(0.0, f - max(s, end))
        if f > end:
            end, last = f, e["name"]
    if t1 > end:
        holes.append((t1 - end, end, last, None))
    host = [e for e in events if e.get("cat") == "cpu_op"]

    def host_at(t):
        inside = [e for e in host if float(e["ts"]) <= t < float(e["ts"]) + float(e["dur"])]
        return min(inside, key=lambda e: float(e["dur"]))["name"] if inside else None

    longest = sorted(holes, key=lambda h: -h[0])[:gaps]
    window_ms = (t1 - t0) / 1e3
    return {
        "window_ms": window_ms,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / (t1 - t0) if t1 > t0 else None,
        "device_ops": len(device),
        "top_ops": [{"name": name, "calls": calls, "ms": us / 1e3}
                    for name, (calls, us) in ranked],
        "longest_gaps": [{"ms": dur / 1e3, "at_ms": (start - t0) / 1e3, "after": before,
                          "before": after, "host_op": host_at(start + dur / 2)}
                         for dur, start, before, after in longest],
    }


def backbone_ms(model, batch):
    """The backbone on ``batch``'s BEV, median ms of 20 CUDA-event timings
    each: with cuDNN's heuristic choice of algorithm, with its autotuner
    (``torch.backends.cudnn.benchmark``, restored after), and as two halves
    of the batch one after the other."""
    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    before = torch.backends.cudnn.benchmark
    with torch.inference_mode():
        bev = model.map_to_bev(model.vfe(batch))
        half = bev["spatial_features"].shape[0] // 2
        halves = [{"spatial_features": bev["spatial_features"][:half]},
                  {"spatial_features": bev["spatial_features"][half:]}]
        out = {"cudnn_heuristic": median_ms(lambda: model.backbone_2d(bev)),
               "two_halves": median_ms(lambda: [model.backbone_2d(h) for h in halves])}
        torch.backends.cudnn.benchmark = True
        out["cudnn_autotuned"] = median_ms(lambda: model.backbone_2d(bev))
    torch.backends.cudnn.benchmark = before
    return out


def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def short_name(name, width=90):
    """``name`` cut to ``width`` characters for a log line."""
    return name if len(name) <= width else name[:width - 3] + "..."


def run(args=None, log=print, card=None):
    """The bench on the card in the modes of ``args`` (``parse_args``; by
    default none): prints the profile lines through ``log`` and returns the
    result line's dict, with the profile under ``"profile"`` and the kernel
    launches of the timed passes under ``"launches"``."""
    args = args or parse_args([])
    card = card or card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, info, model = load_trained_ego("cuda", args)
    batches = bench_batches(args.occupancy, info.num_point_features)
    bev_scatter.reset_launches()
    ms = time_batches(model, batches)
    counts = dict(bev_scatter.launches)
    with torch.inference_mode():
        boxes = model(batches[0])["final_box_dicts"]
    per_cloud = boxes["pred_valid"].sum(1).tolist()

    profile = {}
    for b in (BATCH, BATCH // 2):
        batch = {k: v[:b] for k, v in batches[0].items()}
        summary = trace_summary(trace_forward(model, batch))
        summary["backbone_ms"] = backbone_ms(model, batch)
        profile[f"b{b}"] = summary
        log(f"b{b} forward traced: window {summary['window_ms']:.6f} ms, device busy "
            f"{summary['device_busy_ms']:.6f} ms in {summary['device_ops']} operations, "
            f"idle share {summary['device_idle_share']:.6f}")
        for op in summary["top_ops"]:
            log(f"b{b}   top device op {op['ms']:.6f} ms in {op['calls']} calls: "
                f"{short_name(op['name'])}")
        for gap in summary["longest_gaps"]:
            log(f"b{b}   device gap {gap['ms']:.6f} ms at {gap['at_ms']:.6f} ms, host in "
                f"{gap['host_op']}, after {short_name(str(gap['after']), 60)}, before "
                f"{short_name(str(gap['before']), 60)}")
        log(f"b{b} backbone_2d alone (median of 20, CUDA events): " + ", ".join(
            f"{k} {v:.6f} ms" for k, v in summary["backbone_ms"].items()))
    on = [k for k in ("bf16", "fold_bn", "wpack") if getattr(args, k)]
    if args.pre_reduce:
        on.append(f"pre_reduce {args.pre_reduce}")
    weights = "random init" if args.ckpt == "none" else (
        "trained ckpt" if Path(args.ckpt) == CKPT else f"ckpt {args.ckpt}")
    return {"metric": f"point-clouds/sec/gpu (voxelize->detect->NMS, b{BATCH} n{NPOINTS}, "
                      f"512x512 grid, {args.occupancy}, {weights}, TF32 off"
                      + "".join(f", {m}" for m in on) + ")",
            "value": BATCH / ms * 1e3, "unit": "clouds/s", "ms_per_batch": ms,
            "card": card, "modes": modes(args), "valid_boxes_per_cloud": per_cloud,
            "launches": counts, "profile": profile}


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("pcp_tpu_torch.bench: no CUDA device; the bench runs only on a GPU", file=sys.stderr)
        return 1
    result = run(args, log=lambda msg: print(f"[bench] {msg}", flush=True))
    print(json.dumps({k: v for k, v in result.items() if k not in ("profile", "launches")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
