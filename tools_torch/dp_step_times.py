"""Data-parallel train step times of the port at 1, 2 and 4 cards over NCCL.

    python3 tools_torch/dp_step_times.py [--models ego car] [--cards 1 2 4] [--steps 10]
        [--json PATH]

For each model and card count n, n spawned ranks (rank r on ``cuda:r``,
NCCL, TF32 off) each take the config's per-card batch
(``BATCH_SIZE_PER_GPU``: the global batch is n times it) of chip_smoke.py's
synthetic training batches, at full width: the ego at 32768 points a cloud
(``train_batch``), the car at 65536 (``sender_train_batch``). Each rank
times ``make_train_step``: the host clock around steps that end in a
synchronize, the median of ``--steps`` after 3 warm-ups. Prints, and with
``--json`` writes, one JSON object: per model and card count each rank's
median ms, the slowest rank's, and the global batch's samples a second.
Skips a card count the machine does not have. Imports no JAX.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

WARMUP = 3


def _rank(rank, world, name, steps, seed, tmp):
    from pcp_tpu_torch.entry import build
    from pcp_tpu_torch.parallel import process_group, replicate_state
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank)
    with process_group(rank, world, f"file://{tmp}/rendezvous", "nccl", device):
        cfg_path = chip_smoke.CFG_EGO if name == "ego" else chip_smoke.CFG_CAR
        cfg, info, model = build(cfg_path, device=device)
        b = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
        rng = np.random.default_rng(seed + rank)
        host = (chip_smoke.train_batch(rng, b, chip_smoke.N, info) if name == "ego"
                else chip_smoke.sender_train_batch(rng, b, chip_smoke.SENDER_N, info))
        batch = {k: v.to(device) for k, v in host.items()}
        optimizer, _ = build_optimizer(cfg.OPTIMIZATION, model, total_iters_each_epoch=100,
                                       total_epochs=1)
        replicate_state(create_train_state(model, optimizer, seed))
        step = make_train_step(model, optimizer)
        times = []
        for it in range(WARMUP + steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            float(step(batch)[0])
            torch.cuda.synchronize(device)
            if it >= WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(
            {"batch": b, "median_ms": statistics.median(times), "ms": times}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", nargs="+", default=["ego", "car"], choices=["ego", "car"])
    ap.add_argument("--cards", nargs="+", type=int, default=[1, 2, 4])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_step_times: no CUDA device", file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    have = torch.cuda.device_count()
    out = {"card": torch.cuda.get_device_name(0), "cards_present": have, "torch": torch.__version__,
           "steps": args.steps, "warmup": WARMUP, "results": {}}
    (REPO / "build").mkdir(exist_ok=True)
    for name in args.models:
        for n in args.cards:
            if n > have:
                continue
            with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
                torch.multiprocessing.spawn(_rank, args=(n, name, args.steps, args.seed, tmp),
                                            nprocs=n, join=True)
                ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(n)]
            slowest = max(r["median_ms"] for r in ranks)
            out["results"][f"{name} x{n}"] = {
                "cards": n, "batch_per_card": ranks[0]["batch"],
                "median_ms_by_rank": [r["median_ms"] for r in ranks], "slowest_rank_ms": slowest,
                "samples_per_s": n * ranks[0]["batch"] / slowest * 1e3}
            print(f"[dp_step_times] {name} on {n} card(s): {out['results'][f'{name} x{n}']}",
                  flush=True)
    print(json.dumps(out))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
