"""Sweep the launch numbers of the streaming BEV scatter-max kernels (fused,
one-hot) on one NVIDIA GPU: the tile size of the fused kernel and the blocks
an SM that the spans are cut for.

    python3 tools_torch/sweep_stream_kernels.py [--seed 0] [--rounds 2]

Inputs are chip_smoke.py's main-path shapes (b8 x 32768 x 64 on 512x512,
about 8 points a pillar). Every setting is first held against the default
kernel's output, then timed (median of 20 CUDA-event timings, 8 launches in
a row a timing); the settings take turns, ``--rounds`` times. Prints one line
a timing, one JSON line of the medians and the card as nvidia-smi names it.
The module's own numbers are put back at the end. Without a CUDA device it
exits 1.
"""
import argparse
import itertools
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from pcp_tpu_torch.ops import bev_scatter as bs  # noqa: E402

TILE_BYTES = (4096, 8192, 16384, 32768)
BLOCKS_PER_SM = (8, 16, 32, 64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_stream_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.phase_device()
    g = chip_smoke.GRID
    feats, pids = chip_smoke._sorted_scatter_inputs(np.random.default_rng(args.seed))
    kernels = {"bev_scatter_fused": (bs.bev_scatter_max_sorted_fused_cuda, TILE_BYTES),
               "bev_scatter_onehot": (bs.bev_scatter_max_sorted_onehot_cuda, (bs._TILE_BYTES,))}
    own = (bs._TILE_BYTES, bs._STREAM_BLOCKS_PER_SM)
    times = {}
    with torch.inference_mode():
        want = bs.bev_scatter_max_sorted_cuda(feats, pids, g, g)
        for _ in range(args.rounds):
            for name, (fn, tile_bytes) in kernels.items():
                for tile, blocks in itertools.product(tile_bytes, BLOCKS_PER_SM):
                    bs._TILE_BYTES, bs._STREAM_BLOCKS_PER_SM = tile, blocks
                    if not torch.equal(fn(feats, pids, g, g), want):
                        raise AssertionError(f"{name} != bev_scatter_max at tile bytes {tile}, "
                                             f"blocks an SM {blocks}")
                    ms = chip_smoke.cuda_ms(lambda: fn(feats, pids, g, g), reps=8)
                    key = f"{name} tile_bytes {tile} blocks_per_sm {blocks}"
                    times.setdefault(key, []).append(ms)
                    print(f"[sweep] {key}: {ms:.6f} ms", flush=True)
                bs._TILE_BYTES, bs._STREAM_BLOCKS_PER_SM = own
    print(json.dumps({k: statistics.median(v) for k, v in times.items()}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
