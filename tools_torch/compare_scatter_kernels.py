"""Time the port's fused and one-hot BEV scatter-max kernels against their
one-block-a-tile predecessors (the sources of commit 69ddce4), in turns, on
one NVIDIA GPU. It is how the redesign's gain in PERF.md section 6 was
measured; it takes no later commit as ``--parent``.

    mkdir -p build/parent
    git archive 69ddce4 pcp_tpu_torch/ops/csrc | tar -x -C build/parent
    python3 tools_torch/compare_scatter_kernels.py --parent build/parent [--seed 0]

The earlier sources are built from ``--parent`` as they are, called with
their launch signature ``(feats, pids, out, b, n, hw, c, tile_cells, chunk,
stream)`` and run at their own tile sizes.
Inputs are chip_smoke.py's main-path shapes (b8 x 32768 x 64 on 512x512,
about 8 points a pillar). Each round times earlier, current, current,
earlier (median of 20 CUDA-event timings each, 5 launches in a row a
timing) and then one
``torch.scatter_reduce(..., "amax")`` call; the outputs must be equal. Prints
one JSON line and the card as nvidia-smi names it. Without a CUDA device it
exits 1.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from pcp_tpu_torch.ops import bev_scatter as bs  # noqa: E402
from pcp_tpu_torch.ops import cuda_build  # noqa: E402


def earlier_tile_cells(name, c):
    """Tile sizes the one-block-a-tile kernels were launched with."""
    if name == "bev_scatter_fused":
        return max(1, 16384 // (4 * c))
    cp = -(-c // 16) * 16
    return max(16, 16384 // (4 * cp) // 16 * 16)


def build_earlier(parent, name):
    src = Path(parent) / "pcp_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
    so = cuda_build.BUILD_DIR / f"libearlier_{name}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(so)), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def earlier_call(fn, name, feats, pids, h, w):
    b, n, c = feats.shape
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=feats.device)
    err = fn(feats.data_ptr(), pids.data_ptr(), out.data_ptr(), b, n, h * w, c,
             earlier_tile_cells(name, c), 16, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier {name} launch failed with CUDA error {err}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="directory the earlier commit's "
                    "pcp_tpu_torch/ops/csrc was unpacked into")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_scatter_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.phase_device()
    g = chip_smoke.GRID
    feats, pids = chip_smoke._sorted_scatter_inputs(np.random.default_rng(args.seed))
    current = {"bev_scatter_fused": bs.bev_scatter_max_sorted_fused_cuda,
               "bev_scatter_onehot": bs.bev_scatter_max_sorted_onehot_cuda}
    zeros = torch.zeros((feats.shape[0], g * g + 1, feats.shape[2]), device=feats.device)
    idx = pids.long()[..., None].expand(*feats.shape)
    result = {}
    with torch.inference_mode():
        for name, new_fn in current.items():
            old_fn = build_earlier(args.parent, name)
            old = earlier_call(old_fn, name, feats, pids, g, g)
            new = new_fn(feats, pids, g, g)
            torch.cuda.synchronize()
            if not torch.equal(old, new):
                raise AssertionError(f"{name}: current kernel != earlier kernel, max_abs_err "
                                     f"{(old - new).abs().max().item()}")
            del old, new
            times = {"earlier": [], "current": [], "library": []}
            for _ in range(args.rounds):
                for which in ("earlier", "current", "current", "earlier"):
                    run = ((lambda: earlier_call(old_fn, name, feats, pids, g, g))
                           if which == "earlier" else (lambda: new_fn(feats, pids, g, g)))
                    times[which].append(chip_smoke.cuda_ms(run, reps=5))
                times["library"].append(chip_smoke.cuda_ms(lambda: torch.scatter_reduce(
                    zeros, 1, idx, feats, "amax", include_self=True), reps=5))
            result[name] = {k: {"median_ms": statistics.median(v), "all_ms": v}
                            for k, v in times.items()}
            print(f"[compare] {name}: " + ", ".join(
                f"{k} {v['median_ms']:.6f} ms {['%.6f' % x for x in v['all_ms']]}"
                for k, v in result[name].items()), flush=True)
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
