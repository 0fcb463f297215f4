"""Checkpoints in pcdet's ``.pth`` format, with rotation.

Counterpart of ``pcp_tpu/train/checkpoint.py`` (orbax there): a checkpoint
is ``torch.save`` of ``{"model_state", "optimizer_state", "epoch", "it",
"step"}``, the model state under pcdet's names, so the JAX package's
``pcp_tpu/utils/torch_converter.py::load_torch_checkpoint`` reads the weights
of one. ``checkpoint_epoch_{n}.pth`` files rotate; ``latest_model.pth`` is
the time-interval snapshot between epochs and does not.
"""
import re
from pathlib import Path

import torch


def _payload(state, epoch, it):
    return {"model_state": state.model.state_dict(),
            "optimizer_state": state.optimizer.state_dict(),
            "epoch": int(epoch), "it": int(it), "step": state.step}


def _epoch_files(ckpt_dir):
    return sorted(Path(ckpt_dir).glob("checkpoint_epoch_*.pth"),
                  key=lambda p: int(re.findall(r"\d+", p.name)[-1]))


def save_checkpoint(state, ckpt_dir, epoch, it, max_ckpt_save_num=30, logger=None):
    """Save ``checkpoint_epoch_{epoch}.pth``, first removing the oldest so
    that at most ``max_ckpt_save_num`` remain. Returns the path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    existing = _epoch_files(ckpt_dir)
    while existing and len(existing) >= max_ckpt_save_num:
        existing.pop(0).unlink()
    path = ckpt_dir / f"checkpoint_epoch_{epoch}.pth"
    torch.save(_payload(state, epoch, it), path)
    if logger is not None:
        logger.info(f"checkpoint saved: {path}")
    return path


def save_latest_snapshot(state, ckpt_dir, epoch, it, logger=None):
    """Overwrite ``latest_model.pth``, the snapshot taken between epoch
    boundaries for recovery after a crash."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / "latest_model.pth"
    torch.save(_payload(state, epoch, it), path)
    if logger is not None:
        logger.info(f"latest snapshot saved: {path}")
    return path


def latest_checkpoint(ckpt_dir):
    """The newest ``checkpoint_epoch_*.pth`` in ``ckpt_dir``, or None."""
    files = _epoch_files(ckpt_dir)
    return files[-1] if files else None


def load_checkpoint(path, state=None):
    """With ``state``, restore its model and optimizer from the checkpoint
    (full resume) and return ``(state, epoch, it)``; without, return the
    checkpoint's dict, tensors on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if state is None:
        return ckpt
    state.model.load_state_dict(ckpt["model_state"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer_state"])
    return state, ckpt["epoch"], ckpt["it"]


def load_params_from_file(path):
    """Weights only: the model state dict (parameters and running
    statistics), for ``model.load_state_dict``."""
    return load_checkpoint(path)["model_state"]



def overlay_bev_maker_weights(model, maker_name, agent_ckpt_path, logger=None):
    """Copy the ``vfe``, ``map_to_bev`` and ``backbone_2d`` weights and
    running statistics of a trained single-agent detector (a port
    checkpoint of the car, the RSU or the early ego) into DiscoNet's frozen
    maker ``maker_name`` (``bev_maker_car``, ...), each sub-module strictly;
    counterpart of ``pcp_tpu/train/checkpoint.py::overlay_bev_maker_weights``.
    Returns the maker's state dict after the copy."""
    agent_sd = load_params_from_file(agent_ckpt_path)
    maker = getattr(model, maker_name)
    for sub in ("vfe", "map_to_bev", "backbone_2d"):
        part = {k[len(sub) + 1:]: v for k, v in agent_sd.items() if k.startswith(f"{sub}.")}
        getattr(maker, sub).load_state_dict(part, strict=True)
        if logger is not None:
            logger.info(f"overlaid {maker_name}.{sub} ({len(part)} tensors) from {agent_ckpt_path}")
    return maker.state_dict()
