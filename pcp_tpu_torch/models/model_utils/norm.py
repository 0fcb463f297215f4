"""The two BatchNorm conventions of the JAX package.

* :class:`MaskedBatchNorm`, counterpart of
  ``pcp_tpu/models/model_utils/norm.py::MaskedBatchNorm``: the VFE's point
  buffer is padded, so training statistics come from valid rows only, and
  the running variance takes the *unbiased* batch variance, as torch's does.
* :class:`BatchNorm2d`, counterpart of flax ``nn.BatchNorm`` (backbone and
  head): the running variance takes the *biased* batch variance. Flax
  momentum ``m`` is torch momentum ``1 - m``. With ``compute_dtype``
  bfloat16 it serves as flax's ``BatchNorm(dtype=bfloat16)`` does: from the
  bfloat16 input, ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
  float32, rounded to bfloat16 (flax ``normalization.py::_normalize``).

Both keep pcdet's state-dict names (weight, bias, running_mean, running_var,
num_batches_tracked), and both normalise a training batch by its biased
variance. Under a process group of more than one rank, training statistics
are those of the global batch: sums and counts are all-reduced with autograd
(``parallel.collective.all_reduce_sum``), as XLA computes a BN over a
sharded batch (``nn.SyncBatchNorm`` would take the unbiased running
variance).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.collective import all_reduce_sum, get_dist_info


def rank_sum(t, dim):
    """This rank's sum of ``t`` over ``dim``, the part that the all-reduce
    adds to the other ranks'."""
    return t.sum(dim)


def _global_moments(flat, w):
    """Mean and biased variance over the rows of (rows, C) ``flat`` weighted
    by ``w`` (rows,), over every rank's rows, and the row count (at least
    1)."""
    c = flat.shape[1]
    sums = all_reduce_sum(torch.cat([rank_sum(flat * w[:, None], 0), rank_sum(w, 0)[None]]))
    n = torch.clamp(sums[c], min=1.0)
    mean = sums[:c] / n
    var = all_reduce_sum(rank_sum(((flat - mean) ** 2) * w[:, None], 0)) / n
    return mean, var, n


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of (..., C) with a row validity mask."""

    def forward(self, x, mask=None):
        if not self.training:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        flat = x.reshape(-1, x.shape[-1])
        w = flat.new_ones(flat.shape[0]) if mask is None else mask.reshape(-1).to(flat.dtype)
        mean, var, n = _global_moments(flat, w)
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
    variance, as flax's does. In one process, torch's update
    ``(1 - m) r + m v_unbiased`` is brought to ``(1 - m) r + m v_biased`` by
    scaling its batch term by ``(n - 1) / n``: C values, no second pass over
    the activations; torch updates a copy, since autograd keeps the tensor it
    was given. Under several ranks the moments are the global batch's."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if not self.training:
            if self.compute_dtype is None:
                return super().forward(x)
            mul = (torch.rsqrt(self.running_var + self.eps) * self.weight)[:, None, None]
            y = (x.float() - self.running_mean[:, None, None]) * mul + self.bias[:, None, None]
            return y.to(self.compute_dtype)
        self.num_batches_tracked.add_(1)
        if get_dist_info()[1] > 1:
            return self._global_batch_forward(x)
        updated = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = (1 - self.momentum) * self.running_var
            self.running_var.copy_((updated - keep) * ((n - 1) / n) + keep)
        return y

    def _global_batch_forward(self, x):
        c = x.shape[1]
        sums = all_reduce_sum(torch.cat([rank_sum(x, (0, 2, 3)), x.new_tensor([x.numel() // c])]))
        mean = sums[:c] / sums[c]
        var = all_reduce_sum(rank_sum((x - mean[:, None, None]) ** 2, (0, 2, 3))) / sums[c]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]
