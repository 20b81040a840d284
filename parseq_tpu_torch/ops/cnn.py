"""Convolution, max pooling and batch norm (port of parseq_tpu/ops/cnn.py:
conv2d, max_pool2d, batchnorm).

The JAX package is NHWC; inside the port's CNNs activations are NCHW, as
PyTorch keeps them, and the parameters are those of nn.Conv2d and
nn.BatchNorm2d so reference state_dicts load. The rounding points are the
JAX package's: the convolution runs in x's dtype (f32 accumulation) and
its bias is added after the cast; batch-norm statistics are applied in
float32 and the result cast back. Max pooling is torch's MaxPool2d: floor
mode, padding with -inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(x, conv: nn.Conv2d):
    """x (B, C, H, W) -> conv(x) in x's dtype; bias added after the cast."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)[:, None, None]
    return y


def max_pool2d(x, kernel, stride=None, padding=(0, 0)):
    """x (B, C, H, W) -> max over `kernel` windows, torch MaxPool2d semantics
    (floor mode, -inf padding); stride defaults to the kernel."""
    return F.max_pool2d(x, kernel, stride or kernel, padding)


def batchnorm(x, bn: nn.BatchNorm2d, momentum=0.1):
    """BatchNorm2d over channels of (B, C, H, W), in float32:
    (x - mean) * (rsqrt(var + eps) * scale) + bias, cast to x's dtype.

    Eval mode (`bn.training` unset) uses the running statistics. Train mode
    uses the batch's mean and biased variance and moves the running ones in
    place, torch's momentum convention with the unbiased variance:
    running = (1 - momentum) * running + momentum * batch."""
    if bn.training:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        n = x.numel() / mean.numel()
        with torch.no_grad():
            bn.running_mean.mul_(1 - momentum).add_(momentum * mean)
            bn.running_var.mul_(1 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (x.float() - mean[:, None, None]) * inv[:, None, None]
    return (y + bn.bias.float()[:, None, None]).to(x.dtype)


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d):
    return batchnorm(conv2d(x, conv), bn)
