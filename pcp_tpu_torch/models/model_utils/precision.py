"""Convolutions with flax's ``dtype=``: the parameters stay float32 and a
conv computes in ``compute_dtype``.

Counterpart of ``nn.Conv(dtype=...)`` and ``nn.ConvTranspose(dtype=...)`` in
the JAX package's BF16 serving mode (``MODEL.BF16``): the input, the kernel
and the bias are cast to ``compute_dtype`` and the output comes back in it.
``compute_dtype`` None is the plain float32 conv. In training the backward
is that of the casts, as JAX differentiates flax's: the conv's cotangent
comes back in ``compute_dtype``, and the cast hands the float32 weight,
bias and input their gradients in float32; parameters and optimizer state
stay float32. One difference in the
arithmetic: a biased conv here adds its bias inside the convolution and
rounds once, where flax rounds the conv's output and then the sum, so the
two packages may differ by one bfloat16 ulp on such a layer.
"""
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)
