"""The SECOND 2D backbone's forward time on the card, four ways.

    python3 tools_torch/second_backbone_times.py [--config v2x_second_car] [--iters 10]
        [--json PATH]

Builds the config's model at full width with chip_smoke.py's seeded weights,
runs one b4 forward of ``realistic_points`` (65536 a cloud) to the BEV that
``HeightCompression`` hands on, (4, 256, 128, 128), and times the
``BaseBEVBackbone`` on it (median of ``--iters`` CUDA-event timings after 2
warm-ups, TF32 off) as the port runs it (the channels-last view, cuDNN's
heuristic), on a contiguous NCHW copy, and each again with
``torch.backends.cudnn.benchmark`` on, and a ``torch.profiler`` summary of
one call as run (the top device operations, the idle share); the same for
the anchor car's backbone on its BEV, (4, 64, 512, 512), for scale. Prints,
and with ``--json`` writes, one JSON object of milliseconds. Imports no JAX.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _ms(fn, iters):
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def backbone_times(config, iters, seed=0):
    """{layout: ms} of the config's 2D backbone on its own b4 BEV."""
    from pcp_tpu_torch.entry import build

    cfg, info, model = build(REPO / "tools" / "cfgs" / "v2x_sim_models" / f"{config}.yaml")
    model.load_state_dict(chip_smoke.seeded_state_dict(model, seed), strict=True)
    b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    pts = chip_smoke.realistic_points(np.random.default_rng(seed), b, chip_smoke.SENDER_N,
                                      info.num_point_features)
    batch = {"points": torch.from_numpy(pts).cuda(),
             "points_mask": torch.ones(pts.shape[:2], dtype=torch.bool, device="cuda")}
    with torch.inference_mode():
        d = batch
        for name in model.module_names[:model.module_names.index("backbone_2d")]:
            d = getattr(model, name)(d)
        bev = d["spatial_features"]
        out = {"shape": list(bev.shape), "channels_last_view": bev.is_contiguous(
            memory_format=torch.channels_last)}
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            for layout, x in (("as_run", bev), ("nchw", bev.contiguous())):
                out[f"{layout}{'_benchmark' if bench else ''}_ms"] = _ms(
                    lambda: model.backbone_2d(dict(d, spatial_features=x)), iters)
        torch.backends.cudnn.benchmark = False
        from pcp_tpu_torch.bench import short_name, trace, trace_summary

        summary = trace_summary(trace(lambda: model.backbone_2d(d)), top=8, gaps=0)
        out["profile"] = {"window_ms": summary["window_ms"],
                          "device_idle_share": summary["device_idle_share"],
                          "top_ops": [dict(op, name=short_name(op["name"], 120))
                                      for op in summary["top_ops"]]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="v2x_second_car")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    from pcp_tpu_torch.bench import card_name

    result = {"card": card_name(), "torch": torch.__version__,
              args.config: backbone_times(args.config, args.iters),
              "v2x_pointpillar_anchor_car": backbone_times("v2x_pointpillar_anchor_car", args.iters)}
    print(json.dumps(result))
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
