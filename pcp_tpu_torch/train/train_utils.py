"""Training loop: counterpart of ``pcp_tpu/train/train_utils.py``.

``train_one_epoch`` runs the train step over a loader with the reference's
data/step time meters, an optional ``torch.profiler`` window and the
time-interval ``latest_model`` snapshot; ``train_model`` runs the epochs,
optionally bakes dataset-average BN statistics into the last checkpoint, and
saves rotating checkpoints. A loader is any iterable of numpy batch dicts;
``set_epoch(epoch)`` is called where the loader has it. The trainer runs on
the model's device.
"""
import json
import time
from pathlib import Path

import torch

from .bn_recal import recalibrate_batch_stats
from .checkpoint import save_checkpoint, save_latest_snapshot
from .train_state import make_train_step

def _to_device_batch(batch, device):
    """A batch dict (numpy arrays or tensors, pinned where the loader pinned
    them) as the model takes it, on ``device``: float32 points and gt boxes,
    the bool mask, and where the batch has them the senders'
    ``instances_tf`` (B, Ni, S, 4, 4), a teacher BEV
    ``teacher_spatial_features_2d`` (B, C, H, W) and DiscoNet's agent poses
    ``se3_from_ego_arr`` (B, 6, 4, 4), all float32, and DiscoNet's
    ``agent_present`` (B, 6) bool. The copies are ``non_blocking``: from
    pinned memory they overlap the card's work."""

    def to(x, dtype=None):
        return torch.as_tensor(x).to(device=device, dtype=dtype, non_blocking=True)

    dev = {"points": to(batch["points"], torch.float32), "points_mask": to(batch["points_mask"])}
    for key in ("gt_boxes", "instances_tf", "teacher_spatial_features_2d", "se3_from_ego_arr"):
        if key in batch:
            dev[key] = to(batch[key], torch.float32)
    if "agent_present" in batch:
        dev["agent_present"] = to(batch["agent_present"], torch.bool)
    return dev


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def _model_device(model):
    return next(model.parameters()).device


def train_one_epoch(state, train_loader, epoch, logger=None, tb_writer=None, log_interval=50,
                    step_fn=None, profile_dir=None, profile_steps=(5, 8), profile_epoch=0,
                    ckpt_save_dir=None, ckpt_save_time_interval=300, snapshot_tracker=None,
                    history=None):
    """One pass over ``train_loader``. ``profile_dir``: a ``torch.profiler``
    trace of steps [profile_steps[0], profile_steps[1]) of epoch
    ``profile_epoch`` (fewer where the epoch ends first), the loader's waits
    included, written there as a Chrome trace with its summary (the device's
    busy time and idle share of the window, ``bench.trace_summary``) in
    ``trace_summary.json``. ``ckpt_save_dir``: overwrite ``latest_model.pth``
    every ``ckpt_save_time_interval`` seconds. ``history``: a list to which
    each step appends its epoch, iteration, loss, its ``tb_dict`` terms and
    the optimizer's gradient norm before the clip (``tb``) and the
    milliseconds spent waiting for the batch (``data_ms``) and on the step
    (``step_ms``, the loss read back). Returns (average loss, step_fn, the
    epoch mean of each term of ``tb``)."""
    model = state.model
    device = _model_device(model)
    step_fn = step_fn or make_train_step(model, state.optimizer)
    data_time, step_time, losses = AverageMeter(), AverageMeter(), AverageMeter()
    tb_meters = {}
    prof = None
    total = len(train_loader) if hasattr(train_loader, "__len__") else "?"
    end = time.time()
    for it, batch in enumerate(train_loader):
        if profile_dir is not None and epoch == profile_epoch:
            if it == profile_steps[0] and prof is None:
                prof = _start_profile(device)
            elif it == profile_steps[1] and prof is not None:
                _stop_profile(prof, profile_dir, device, logger)
                prof = None
        data_time.update(time.time() - end)
        loss, tb = step_fn(_to_device_batch(batch, device))
        loss = float(loss)
        step_time.update(time.time() - end - data_time.val)
        losses.update(loss)
        grad_norm = getattr(state.optimizer, "grad_norm", None)
        tb = {k: float(v) for k, v in tb.items()}
        if grad_norm is not None:
            tb["grad_norm"] = float(grad_norm)
        for k, v in tb.items():
            tb_meters.setdefault(k, AverageMeter()).update(v)
        if history is not None:
            history.append({"epoch": epoch, "it": it, "loss": loss, "tb": tb,
                            "data_ms": data_time.val * 1e3, "step_ms": step_time.val * 1e3})
        if logger is not None and it % log_interval == 0:
            logger.info(f"epoch {epoch} it {it}/{total} loss {loss:.4f} "
                        f"(avg {losses.avg:.4f}) data {data_time.avg * 1e3:.0f}ms "
                        f"step {step_time.avg * 1e3:.0f}ms")
        if tb_writer is not None:
            tb_writer.add_scalar("train/loss", loss, state.step)
            for k, v in tb.items():
                tb_writer.add_scalar(f"train/{k}", v, state.step)
        if (ckpt_save_dir is not None and snapshot_tracker is not None
                and time.time() - snapshot_tracker.get("t", 0.0) > ckpt_save_time_interval):
            save_latest_snapshot(state, ckpt_save_dir, epoch, it, logger=logger)
            snapshot_tracker["t"] = time.time()
        end = time.time()
    if prof is not None:
        _stop_profile(prof, profile_dir, device, logger)
    return losses.avg, step_fn, {k: m.avg for k, m in tb_meters.items()}


def _start_profile(device):
    from ..bench import WINDOW

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    prof.window = torch.profiler.record_function(WINDOW)
    prof.window.__enter__()
    return prof


def _stop_profile(prof, profile_dir, device, logger=None):
    from ..bench import trace_summary

    if device.type == "cuda":
        torch.cuda.synchronize()
    prof.window.__exit__(None, None, None)
    prof.stop()
    profile_dir = Path(profile_dir)
    profile_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(profile_dir / "trace.json"))
    summary = trace_summary(json.loads((profile_dir / "trace.json").read_text()), top=10, gaps=3)
    (profile_dir / "trace_summary.json").write_text(json.dumps(summary, indent=1))
    if logger is not None:
        logger.info(f"profile: window {summary['window_ms']:.3f} ms, device busy "
                    f"{summary['device_busy_ms']:.3f} ms, idle share "
                    f"{summary['device_idle_share']:.6f} -> {profile_dir}")


def train_model(state, train_loader, total_epochs, ckpt_dir, logger=None, max_ckpt_save_num=30,
                start_epoch=0, tb_writer=None, profile_dir=None, ckpt_save_time_interval=300,
                precise_bn_batches=0, precise_bn_every=0, profile_epoch=0, profile_steps=(5, 8),
                history=None):
    """Epochs ``start_epoch`` .. ``total_epochs - 1``, a checkpoint after each.
    ``precise_bn_batches > 0`` replaces the running statistics by their
    average over that many batches (``bn_recal.py``) before the last epoch's
    checkpoint, and every ``precise_bn_every``-th epoch's if that is set:
    the training forward never reads them, so this changes evaluation only."""
    step_fn = make_train_step(state.model, state.optimizer)
    device = _model_device(state.model)
    snapshot_tracker = {"t": time.time()}
    for epoch in range(start_epoch, total_epochs):
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        avg_loss, step_fn, tb_means = train_one_epoch(
            state, train_loader, epoch, logger=logger, tb_writer=tb_writer, step_fn=step_fn,
            profile_dir=profile_dir, profile_epoch=profile_epoch, profile_steps=profile_steps,
            ckpt_save_dir=ckpt_dir, ckpt_save_time_interval=ckpt_save_time_interval,
            snapshot_tracker=snapshot_tracker, history=history)
        bake = precise_bn_batches > 0 and (
            epoch == total_epochs - 1
            or (precise_bn_every > 0 and (epoch + 1) % precise_bn_every == 0))
        if bake:
            recalibrate_batch_stats(state.model, train_loader,
                                    lambda b: _to_device_batch(b, device),
                                    max_batches=precise_bn_batches, logger=logger)
        save_checkpoint(state, ckpt_dir, epoch + 1, state.step,
                        max_ckpt_save_num=max_ckpt_save_num, logger=logger)
        if logger is not None:
            terms = " ".join(f"{k} {v:.4f}" for k, v in tb_means.items())
            logger.info(f"epoch {epoch} done, avg loss {avg_loss:.4f} | {terms}")
    return state
