"""Copy one training run of the port's CLIs out of its output tree, small
enough to carry off the machine: its logs, step history and metrics, and
the model state (no optimizer state) of chosen epochs' checkpoints.

    python3 tools_torch/export_run.py <run dir> <out dir> [--f32 25] [--bf16 17] [--bf16_optim 17]

``--f32 N`` writes ``model_epoch_N.pt``, the model state of
``ckpt/checkpoint_epoch_N.pth`` as it is. ``--bf16 N`` writes the same with
every floating parameter stored in bfloat16 (running statistics
untouched), which halves what has to be carried; cast back to float32, it
gives both packages the same rounded weights. ``--bf16_optim N`` writes
``optim_epoch_N_bf16.pt``: the optimizer's moments of that checkpoint by
parameter name, in bfloat16, and its step count. Prints each file written
with its size.
"""
import argparse
import shutil
from pathlib import Path

import torch


def model_state(ckpt, round_bf16=False):
    state = torch.load(ckpt, map_location="cpu", weights_only=False)["model_state"]
    if round_bf16:
        names = [k for k in state if not k.rsplit(".", 1)[-1].startswith(("running_", "num_batches"))]
        for k in names:
            if state[k].is_floating_point():
                state[k] = state[k].to(torch.bfloat16)
    return state


def optimizer_state(ckpt, model_keys):
    """{"count", "mu": {name: bf16}, "nu": {name: bf16}} of a checkpoint of
    ``AdamOneCycle``; the optimizer's parameters are the model's in
    ``named_parameters`` order (``build_optimizer``), which ``model_keys``
    lists."""
    opt = torch.load(ckpt, map_location="cpu", weights_only=False)["optimizer_state"]
    group = opt["param_groups"][0]
    names = [model_keys[i] for i in range(len(group["params"]))]
    out = {"count": int(group["count"]), "mu": {}, "nu": {}}
    for name, idx in zip(names, group["params"]):
        for key in ("mu", "nu"):
            out[key][name] = opt["state"][idx][key].to(torch.bfloat16)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("run_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--f32", type=int, nargs="*", default=[])
    parser.add_argument("--bf16", type=int, nargs="*", default=[])
    parser.add_argument("--bf16_optim", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    run, out = Path(args.run_dir), Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for pattern in ("log_train_*.txt", "train_history_*.json", "eval/**/log_eval_*.txt",
                    "eval/**/metrics.json", "profile/trace_summary.json"):
        for f in run.glob(pattern):
            dst = out / f.relative_to(run)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, dst)
    for epochs, rnd in ((args.f32, False), (args.bf16, True)):
        for e in epochs:
            dst = out / f"model_epoch_{e}{'_bf16' if rnd else ''}.pt"
            torch.save(model_state(run / "ckpt" / f"checkpoint_epoch_{e}.pth", rnd), dst)
            print(f"{dst} {dst.stat().st_size} bytes")
    for e in args.bf16_optim:
        ckpt = run / "ckpt" / f"checkpoint_epoch_{e}.pth"
        params = [k for k, v in model_state(ckpt).items()
                  if not k.rsplit(".", 1)[-1].startswith(("running_", "num_batches"))]
        dst = out / f"optim_epoch_{e}_bf16.pt"
        torch.save(optimizer_state(ckpt, params), dst)
        print(f"{dst} {dst.stat().st_size} bytes")


if __name__ == "__main__":
    main()
