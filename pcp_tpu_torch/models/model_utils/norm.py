"""The two BatchNorm conventions of the JAX package.

* :class:`MaskedBatchNorm`, counterpart of
  ``pcp_tpu/models/model_utils/norm.py::MaskedBatchNorm``: the VFE's point
  buffer is padded, so training statistics come from valid rows only, and
  the running variance takes the *unbiased* batch variance, as torch's does.
* :class:`BatchNorm2d`, counterpart of flax ``nn.BatchNorm`` (backbone and
  head): the running variance takes the *biased* batch variance. Flax
  momentum ``m`` is torch momentum ``1 - m``.

Both keep pcdet's state-dict names (weight, bias, running_mean, running_var,
num_batches_tracked), and both normalise a training batch by its biased
variance.
"""
import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of (..., C) with a row validity mask."""

    def forward(self, x, mask=None):
        if not self.training:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        c = x.shape[-1]
        flat = x.reshape(-1, c)
        if mask is None:
            w = flat.new_ones(flat.shape[0])
        else:
            w = mask.reshape(-1).to(flat.dtype)
        n = torch.clamp(w.sum(), min=1.0)
        mean = (flat * w[:, None]).sum(0) / n
        var = (((flat - mean) ** 2) * w[:, None]).sum(0) / n
        with torch.no_grad():
            m = self.momentum
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * unbiased)
            self.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance takes the biased batch
    variance, as flax's does. Torch's update ``(1 - m) r + m v_unbiased`` is
    brought to ``(1 - m) r + m v_biased`` by scaling its batch term by
    ``(n - 1) / n``: C values, no second pass over the activations. Torch
    updates a copy, since autograd keeps the tensor it was given."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        updated = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = (1 - self.momentum) * self.running_var
            self.running_var.copy_((updated - keep) * ((n - 1) / n) + keep)
        return y
