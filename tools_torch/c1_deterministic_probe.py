"""Train the car sender twice on seed 0 under deterministic algorithms,
evaluate both runs and compare them (ROADMAP C1's probe: does one seed
give one car, so that the spread of its row is the seed's and not the
card's?).

    python3 tools_torch/c1_deterministic_probe.py [--output_root build/c1det] \
        [--json build/c1_deterministic.json]

Each run is the synvf car recipe of ``pcp_tpu_torch/workspace/synth_experiments.sh``
(``train_car``, then ``eval_car``) through the train and test CLIs' ``main``
in this process, with ``torch.use_deterministic_algorithms(True)`` (an op
without a deterministic implementation warns, and its message is kept),
cuDNN's deterministic algorithms without benchmarking, and
``CUBLAS_WORKSPACE_CONFIG=:4096:8``. The JSON holds, per run, the steps,
the median step and data milliseconds, mAP, AP at 0.5 m, ATE and AOE;
whether the runs' step losses and loss terms (``train_history_*.json``)
and their final checkpoints agree bitwise, and if not where they part; and
the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from pcp_tpu_torch.tools import test as test_cli  # noqa: E402
from pcp_tpu_torch.tools import train as train_cli  # noqa: E402

CFG = "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml"
SYN = ("{'NUM_SCENES': 15, 'KEYFRAMES_PER_SCENE': 12, 'NUM_CARS': 24, 'NUM_PEDS': 8, "
       "'WORLD': 'urban', 'NUM_PARKED': 16, 'VISIBLE_FACES': True}")
COMMON = ["DATA_CONFIG.USE_SYNTHETIC_DATA", "True", "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "32768",
          "DATA_CONFIG.SYNTHETIC", SYN, "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1",
          "OPTIMIZATION.LR", "0.003"]
EPOCHS = 25
SEED, RUNS, WORKERS = 0, 2, 6
EVAL_KEYS = ("mAP", "car_AP_dist_0.5", "car_ATE", "car_AOE")


def run_once(tag, root):
    """Train and evaluate one car; returns its record and run directory."""
    base = ["--cfg_file", CFG, "--batch_size", "4", "--extra_tag", tag, "--workers", str(WORKERS),
            "--output_root", str(root)]
    summary = train_cli.main(base + ["--epochs", str(EPOCHS), "--seed", str(SEED),
                                     "--num_epochs_to_eval", "0", "--set", *COMMON,
                                     "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "4"])
    run_dir = root / "cfgs" / "v2x_sim_models" / Path(CFG).stem / tag
    result = test_cli.main(base + ["--eval_tag", "car", "--ckpt",
                                   str(run_dir / "ckpt" / f"checkpoint_epoch_{EPOCHS}.pth"),
                                   "--set", *COMMON, "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "1"])
    record = {"tag": tag, "steps": summary["steps"], "step_ms_median": summary["step_ms_median"],
              "data_ms_median": summary["data_ms_median"]}
    record.update({k: float(result[k]) for k in EVAL_KEYS})
    return record, run_dir


def first_difference(a, b):
    """Index of the first entry where two equal-length lists differ, else None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def compare(run_dirs):
    """Bitwise agreement of the runs' step histories and final checkpoints."""
    histories = [json.loads(next(d.glob("train_history_*.json")).read_text()) for d in run_dirs]
    a, b = histories[0], histories[1]
    out = {"steps": [len(h) for h in histories]}
    for key in sorted(k for k in a[0] if k not in ("data_ms", "step_ms")):
        xa, xb = [h.get(key) for h in a], [h.get(key) for h in b]
        out[f"{key}_bitwise_equal"] = xa == xb
        out[f"{key}_first_differing_step"] = first_difference(xa, xb)
    states = [torch.load(next(d.glob(f"ckpt/checkpoint_epoch_{EPOCHS}.pth")), map_location="cpu",
                         weights_only=True)["model_state"] for d in run_dirs]
    differing = [k for k in states[0] if not torch.equal(states[0][k], states[1][k])]
    out.update(state_tensors=len(states[0]), state_tensors_differing=len(differing),
               state_bitwise_equal=not differing, state_first_differing=differing[:5])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output_root", default="build/c1det")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("c1_deterministic_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    root = Path(args.output_root)
    runs, run_dirs = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(RUNS):
            record, run_dir = run_once(f"synvf_det_s{SEED}_{i}", root)
            runs.append(record)
            run_dirs.append(run_dir)
            print(json.dumps(record), flush=True)
    nondeterministic = sorted({str(w.message) for w in caught if "deterministic" in str(w.message)})
    out = {"card": card, "torch": torch.__version__, "seed": SEED, "runs": runs,
           "nondeterministic_warnings": nondeterministic, "agreement": compare(run_dirs)}
    print(json.dumps(out, indent=1))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
