"""Training loop: counterpart of ``pcp_tpu/train/train_utils.py``.

``train_one_epoch`` runs the train step over a loader with the reference's
data/step time meters, an optional ``torch.profiler`` window and the
time-interval ``latest_model`` snapshot; ``train_model`` runs the epochs,
optionally bakes dataset-average BN statistics into the last checkpoint, and
saves rotating checkpoints. A loader is any iterable of numpy batch dicts;
``set_epoch(epoch)`` is called where the loader has it. The trainer runs on
the model's device.
"""
import time
from pathlib import Path

import torch

from .bn_recal import recalibrate_batch_stats
from .checkpoint import save_checkpoint, save_latest_snapshot
from .train_state import make_train_step

def _to_device_batch(batch, device):
    """A numpy batch dict as the model takes it, on ``device``: float32
    points and gt boxes, the bool mask, and where the batch has them the
    senders' ``instances_tf`` (B, Ni, S, 4, 4) and a teacher BEV
    ``teacher_spatial_features_2d`` (B, C, H, W), both float32."""
    dev = {"points": torch.as_tensor(batch["points"], dtype=torch.float32, device=device),
           "points_mask": torch.as_tensor(batch["points_mask"], device=device)}
    for key in ("gt_boxes", "instances_tf", "teacher_spatial_features_2d"):
        if key in batch:
            dev[key] = torch.as_tensor(batch[key], dtype=torch.float32, device=device)
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
                    step_fn=None, profile_dir=None, profile_steps=(5, 8), ckpt_save_dir=None,
                    ckpt_save_time_interval=300, snapshot_tracker=None):
    """One pass over ``train_loader``. ``profile_dir``: a ``torch.profiler``
    trace of steps [profile_steps[0], profile_steps[1]) of epoch 0, written
    there as a Chrome trace. ``ckpt_save_dir``: overwrite ``latest_model.pth``
    every ``ckpt_save_time_interval`` seconds. Returns (average loss,
    step_fn)."""
    model = state.model
    device = _model_device(model)
    step_fn = step_fn or make_train_step(model, state.optimizer)
    data_time, step_time, losses = AverageMeter(), AverageMeter(), AverageMeter()
    prof = None
    total = len(train_loader) if hasattr(train_loader, "__len__") else "?"
    end = time.time()
    for it, batch in enumerate(train_loader):
        if profile_dir is not None and epoch == 0:
            if it == profile_steps[0] and prof is None:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            elif it == profile_steps[1] and prof is not None:
                _stop_profile(prof, profile_dir)
                prof = None
        data_time.update(time.time() - end)
        loss, tb = step_fn(_to_device_batch(batch, device))
        loss = float(loss)
        step_time.update(time.time() - end - data_time.val)
        losses.update(loss)
        if logger is not None and it % log_interval == 0:
            logger.info(f"epoch {epoch} it {it}/{total} loss {loss:.4f} "
                        f"(avg {losses.avg:.4f}) data {data_time.avg * 1e3:.0f}ms "
                        f"step {step_time.avg * 1e3:.0f}ms")
        if tb_writer is not None:
            tb_writer.add_scalar("train/loss", loss, state.step)
            for k, v in tb.items():
                tb_writer.add_scalar(f"train/{k}", float(v), state.step)
        if (ckpt_save_dir is not None and snapshot_tracker is not None
                and time.time() - snapshot_tracker.get("t", 0.0) > ckpt_save_time_interval):
            save_latest_snapshot(state, ckpt_save_dir, epoch, it, logger=logger)
            snapshot_tracker["t"] = time.time()
        end = time.time()
    if prof is not None:
        _stop_profile(prof, profile_dir)
    return losses.avg, step_fn


def _stop_profile(prof, profile_dir):
    prof.stop()
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))


def train_model(state, train_loader, total_epochs, ckpt_dir, logger=None, max_ckpt_save_num=30,
                start_epoch=0, tb_writer=None, profile_dir=None, ckpt_save_time_interval=300,
                precise_bn_batches=0, precise_bn_every=0):
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
        avg_loss, step_fn = train_one_epoch(
            state, train_loader, epoch, logger=logger, tb_writer=tb_writer, step_fn=step_fn,
            profile_dir=profile_dir, ckpt_save_dir=ckpt_dir,
            ckpt_save_time_interval=ckpt_save_time_interval, snapshot_tracker=snapshot_tracker)
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
            logger.info(f"epoch {epoch} done, avg loss {avg_loss:.4f}")
    return state
