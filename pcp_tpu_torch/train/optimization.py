"""Optimizers and LR schedules: counterpart of ``pcp_tpu/train/optimization.py``.

* :class:`AdamOneCycle`: Adam (beta2 0.99, bias-corrected with the current
  beta1) with *decoupled* weight decay ``-lr * wd * p`` on every parameter,
  BN and biases included (fastai's true_wd), and the OneCycle schedule
  driving both the LR and beta1 with cosine phases: the LR goes from
  ``lr_max / div`` to ``lr_max`` over ``pct_start`` of the steps, then to
  ``lr_max / div / 1e4``; beta1 from ``moms[0]`` to ``moms[1]`` and back.
* ``adam`` and ``sgd`` with the step-decay schedule of :func:`decay_step_fns`:
  torch's ``Adam`` and ``SGD`` (their coupled weight decay is optax's
  ``add_decayed_weights`` in front of ``scale_by_adam`` / ``trace``).

Every optimizer here reads its schedule at the count of steps taken before
the step, and first clips the gradients by their global norm with optax's
formula (:func:`clip_by_global_norm_`). Each keeps that count and the clip
in its param group (``count``, ``grad_norm_clip``), so they travel with its
``state_dict``.
"""
import math

import torch


def annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def one_cycle_fns(total_steps, lr_max, moms, div_factor, pct_start):
    """(lr_fn, mom_fn): step (0-based) -> value, with the reference's
    OneCycle phases split at ``int(total_steps * pct_start)``."""
    a1 = int(total_steps * pct_start)
    low_lr = lr_max / div_factor

    def phase(step, start, end):
        return (step - start) / max(end - start, 1)

    def lr_fn(step):
        if step < a1:
            return annealing_cos(low_lr, lr_max, phase(step, 0, a1))
        return annealing_cos(lr_max, low_lr / 1e4, phase(step, a1, total_steps))

    def mom_fn(step):
        if step < a1:
            return annealing_cos(moms[0], moms[1], phase(step, 0, a1))
        return annealing_cos(moms[1], moms[0], phase(step, a1, total_steps))

    return lr_fn, mom_fn


def decay_step_fns(total_iters_each_epoch, optim_cfg):
    """LambdaLR-style step decay: LR times LR_DECAY at each epoch of
    DECAY_STEP_LIST, never under LR_CLIP."""
    lr = float(optim_cfg["LR"])
    decay_steps = [x * total_iters_each_epoch for x in optim_cfg["DECAY_STEP_LIST"]]
    lr_decay = float(optim_cfg["LR_DECAY"])
    lr_clip = float(optim_cfg["LR_CLIP"])

    def lr_fn(step):
        cur_decay = 1.0
        for ds in decay_steps:
            if step >= ds:
                cur_decay *= lr_decay
        return lr * max(cur_decay, lr_clip / lr)

    return lr_fn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm):
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    norm is at least ``max_norm`` (optax's ``clip_by_global_norm``, which
    computes ``g / norm * max_norm``; ``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead). Returns the norm before clipping, a tensor.
    The host does not wait for the card: the choice is a tensor."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm > 0:
        torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm


def _grads(params):
    """The gradient of each parameter, zeros for one that got none (JAX
    differentiates every leaf)."""
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class AdamOneCycle(torch.optim.Optimizer):
    """Counterpart of ``adam_onecycle``; the state of a parameter is ``mu``
    and ``nu``, and a group's ``count`` is optax's step count. After a step,
    ``grad_norm`` holds the global gradient norm before the clip (a tensor on
    the parameters' device)."""

    def __init__(self, params, lr_fn, mom_fn, weight_decay, b2=0.99, eps=1e-8, grad_norm_clip=0.0):
        super().__init__(params, dict(weight_decay=weight_decay, b2=b2, eps=eps,
                                      grad_norm_clip=grad_norm_clip, count=0))
        self.lr_fn, self.mom_fn = lr_fn, mom_fn

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamOneCycle takes no closure")
        for group in self.param_groups:
            params = group["params"]
            grads = _grads(params)
            self.grad_norm = clip_by_global_norm_(grads, group["grad_norm_clip"])
            count = group["count"]
            b1, b2, lr = self.mom_fn(count), group["b2"], self.lr_fn(count)
            t = count + 1
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            # p + -(lr * (mu / bc1) / (sqrt(nu / bc2) + eps) + lr * wd * p)
            denom = torch._foreach_div(nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            adam = torch._foreach_div(torch._foreach_div(mu, 1.0 - b1 ** t), denom)
            update = torch._foreach_mul(params, lr * group["weight_decay"])
            torch._foreach_add_(update, adam, alpha=lr)
            torch._foreach_sub_(params, update)
            group["count"] = t


class _StepDecay:
    """For torch's Adam and SGD: clip, then the LR of ``lr_fn(count)``."""

    def _setup(self, lr_fn, grad_norm_clip):
        self.lr_fn = lr_fn
        for group in self.param_groups:
            group.update(count=0, grad_norm_clip=grad_norm_clip)

    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            self.grad_norm = clip_by_global_norm_(
                [p.grad for p in group["params"] if p.grad is not None], group["grad_norm_clip"])
            group["lr"] = self.lr_fn(group["count"])
        super().step()
        for group in self.param_groups:
            group["count"] += 1


class AdamStepDecay(_StepDecay, torch.optim.Adam):
    """optax ``add_decayed_weights`` -> ``scale_by_adam`` (0.9, 0.999, 1e-8)
    -> ``scale_by_schedule(-lr_fn)``."""

    def __init__(self, params, lr_fn, weight_decay, grad_norm_clip=0.0):
        torch.optim.Adam.__init__(self, params, lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
        self._setup(lr_fn, grad_norm_clip)


class SGDStepDecay(_StepDecay, torch.optim.SGD):
    """optax ``add_decayed_weights`` -> ``trace(momentum)`` ->
    ``scale_by_schedule(-lr_fn)``."""

    def __init__(self, params, lr_fn, weight_decay, momentum, grad_norm_clip=0.0):
        torch.optim.SGD.__init__(self, params, lr=lr_fn(0), momentum=momentum,
                                 weight_decay=weight_decay)
        self._setup(lr_fn, grad_norm_clip)


def build_optimizer(optim_cfg, model, total_iters_each_epoch, total_epochs,
                    frozen_substrings=("bev_maker", "teacher")):
    """The OPTIMIZATION config's optimizer over ``model``'s parameters, with
    GRAD_NORM_CLIP. Returns (optimizer, lr_fn); lr_fn is for logging.
    Parameters whose name holds one of ``frozen_substrings`` are left out:
    no update, no decay."""
    total_steps = total_iters_each_epoch * total_epochs
    name = optim_cfg["OPTIMIZER"]
    clip = float(optim_cfg.get("GRAD_NORM_CLIP", 0) or 0)
    wd = float(optim_cfg["WEIGHT_DECAY"])
    params = [p for n, p in model.named_parameters()
              if not any(s in n for s in frozen_substrings)]
    if name == "adam_onecycle":
        lr_fn, mom_fn = one_cycle_fns(total_steps, float(optim_cfg["LR"]),
                                      [float(m) for m in optim_cfg["MOMS"]],
                                      float(optim_cfg["DIV_FACTOR"]), float(optim_cfg["PCT_START"]))
        return AdamOneCycle(params, lr_fn, mom_fn, wd, grad_norm_clip=clip), lr_fn
    lr_fn = decay_step_fns(total_iters_each_epoch, optim_cfg)
    if name == "adam":
        return AdamStepDecay(params, lr_fn, wd, grad_norm_clip=clip), lr_fn
    if name == "sgd":
        return SGDStepDecay(params, lr_fn, wd, float(optim_cfg["MOMENTUM"]), grad_norm_clip=clip), lr_fn
    raise NotImplementedError(f"optimizer {name!r}")
