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

from parseq_tpu_torch.parallel import dist


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
    running = (1 - momentum) * running + momentum * batch. On several ranks
    the batch is the global one, as the JAX package's SPMD step sees it
    (_global_moments), so the statistics and the running ones are equal on
    every rank."""
    if bn.training:
        x32 = x.float()
        if dist.world_size() > 1:
            mean, var, n = _global_moments(x32)
            unbiased = n / (n - 1).clamp(min=1)
        else:
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
            n = x.numel() / mean.numel()
            unbiased = n / max(n - 1, 1)
        with torch.no_grad():
            bn.running_mean.mul_(1 - momentum).add_(momentum * mean)
            bn.running_var.mul_(1 - momentum).add_(momentum * var * unbiased)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (x.float() - mean[:, None, None]) * inv[:, None, None]
    return (y + bn.bias.float()[:, None, None]).to(x.dtype)


def _global_moments(x32):
    """(mean, biased variance, count) per channel of (B, C, H, W) over every
    rank's rows, through one all-reduce (and one in the backward) of each
    rank's (n * mean, n * (var + mean^2), n). Those sums are taken in
    float64, so that the variance's difference of squares keeps x32's
    precision; the count is a 0-dim float64 tensor."""
    var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
    mean64, n = mean.double(), x32.numel() / mean.numel()
    local = torch.cat([mean64, var.double() + mean64 * mean64, mean64.new_ones(1)]) * n
    sums = dist.sum_over_ranks(local)
    C, count = mean.numel(), sums[-1]
    g_mean = sums[:C] / count
    g_var = sums[C:2 * C] / count - g_mean * g_mean
    return g_mean.to(x32.dtype), g_var.to(x32.dtype), count


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d):
    return batchnorm(conv2d(x, conv), bn)
