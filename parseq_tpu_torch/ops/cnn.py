"""Convolution, max pooling and batch norm (port of parseq_tpu/ops/cnn.py:
conv2d, max_pool2d, batchnorm).

The JAX package is NHWC; inside the port's CNNs activations are NCHW, as
PyTorch keeps them, and the parameters are those of nn.Conv2d and
nn.BatchNorm2d so reference state_dicts load. The rounding points are the
JAX package's: the convolution runs in x's dtype (f32 accumulation) and
its bias is added after the cast; batch-norm statistics are applied in
float32 and the result cast back. Max pooling is torch's MaxPool2d: floor
mode, padding with -inf.

A convolution's eval-mode batch norm, with the shortcut added after it and
the ReLU after that (`bn_act`, `conv_bn`), runs as one launch of the
hand-written CUDA kernel csrc/bn_act.cu where `takes_kernel` holds: a CUDA
tensor in bf16 or f32, NCHW or channels-last, the batch norm in eval mode,
autograd off, `kernels.enabled()`. The kernel keeps every rounding point of
the separate calls, so its output is theirs bit for bit; anything else
(training, the CPU, `kernels.plain()`) makes those calls. `launches` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from parseq_tpu_torch import kernels
from parseq_tpu_torch.kernels.build import CSRC, load_library
from parseq_tpu_torch.parallel import dist

# Launches of csrc/bn_act.cu in this process.
launches = 0

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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
    every rank. In eval mode one launch of the kernel where `takes_kernel`
    holds, with the same result."""
    if takes_kernel(x, bn):
        return _launch(x, bn)
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


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, relu=False, residual=None,
            residual_bn=None):
    """bn_act(conv2d(x, conv), bn, ...): a convolution, its batch norm, the
    shortcut added and the ReLU."""
    return bn_act(conv2d(x, conv), bn, relu, residual, residual_bn)


def bn_act(y, bn: nn.BatchNorm2d, relu=False, residual=None, residual_bn=None):
    """relu(batchnorm(y, bn) + shortcut) in y's dtype, each part optional:
    the shortcut is `residual` (the identity), or batchnorm(residual,
    residual_bn) (a downsampling convolution's output and its batch norm);
    the ReLU where `relu`. The rounding points are those of the separate
    calls: each batch norm rounds to y's dtype, the sum rounds, then the
    ReLU. One launch of csrc/bn_act.cu where `takes_kernel` holds, else those
    calls."""
    if takes_kernel(y, bn, residual, residual_bn):
        return _launch(y, bn, relu, residual, residual_bn)
    out = batchnorm(y, bn)
    if residual is not None:
        out = out + (residual if residual_bn is None else batchnorm(residual, residual_bn))
    return F.relu(out) if relu else out


def takes_kernel(y, bn, residual=None, residual_bn=None):
    """The kernel's one gate: whether bn_act(y, bn, ..., residual,
    residual_bn) runs as one launch of csrc/bn_act.cu. `_allowed` for y and
    both batch norms, and tensors the kernel takes (`_unfit`)."""
    training = bn.training or (residual_bn is not None and residual_bn.training)
    return (_allowed(y.device, y.dtype, training)
            and _unfit(y, bn, residual, residual_bn) is None)


def _allowed(device, dtype, training):
    """The part of the gate that asks no tensor's layout: a CUDA device, bf16
    or f32, eval mode, autograd off (torch.inference_mode() or no_grad),
    `kernels.enabled()`."""
    return (device.type == 'cuda' and dtype in KERNEL_DTYPES and not training
            and not torch.is_grad_enabled() and kernels.enabled())


def _unfit(y, bn, residual, residual_bn):
    """None where the kernel takes the tensors, else why not: y (B, C, H, W)
    bf16 or f32, dense NCHW or channels-last, under 2**31 elements; each
    batch norm's running mean and variance, weight and bias C contiguous
    float32 elements on y's device (the kernel reads them); `residual` of
    y's shape, dtype, device and layout."""
    if y.dtype not in KERNEL_DTYPES or y.dim() != 4:
        return f'y must be a 4-d bf16 or f32 tensor, got {tuple(y.shape)} {y.dtype}'
    fmt = torch.contiguous_format if y.is_contiguous() else torch.channels_last
    if not y.is_contiguous(memory_format=fmt):
        return f'y must be dense NCHW or channels-last, got strides {y.stride()}'
    if not 0 < y.numel() < 2 ** 31:
        return f'y must hold 1 to 2**31 - 1 elements, got {y.numel()}'
    C = y.shape[1]
    for norm in (bn, residual_bn):
        if norm is not None and not all(
                t is not None and t.dtype == torch.float32 and t.numel() == C
                and t.is_contiguous() and t.device == y.device
                for t in (norm.running_mean, norm.running_var, norm.weight, norm.bias)):
            return (f'the batch norms need running statistics, weight and bias of {C} '
                    f'float32 elements on {y.device}')
    if residual is not None and (
            residual.shape != y.shape or residual.dtype != y.dtype
            or residual.device != y.device or not residual.is_contiguous(memory_format=fmt)):
        return (f'residual must be a {tuple(y.shape)} {y.dtype} tensor on {y.device} in y\'s '
                f'layout, got {tuple(residual.shape)} {residual.dtype} on {residual.device} '
                f'with strides {residual.stride()}')
    if residual_bn is not None and residual is None:
        return 'residual_bn needs a residual'
    return None


# parseq_bn_act's parameters: y, r, out; mean, var, weight, bias and eps of
# the batch norm and of the shortcut's; shortcut, n, C, inner, dtype, relu;
# the stream
_STATS = [ctypes.c_void_p] * 4 + [ctypes.c_float]
ARGTYPES = [ctypes.c_void_p] * 3 + _STATS * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.cache
def library():
    """Build (first use) and load csrc/bn_act.cu with its ctypes signatures."""
    lib = load_library('bn_act', (CSRC / 'bn_act.cu',))
    lib.parseq_bn_act.argtypes = ARGTYPES
    lib.parseq_bn_act.restype = ctypes.c_int
    lib.parseq_bn_act_error_string.argtypes = [ctypes.c_int]
    lib.parseq_bn_act_error_string.restype = ctypes.c_char_p
    return lib


def _launch(y, bn, relu=False, residual=None, residual_bn=None):
    """One launch of csrc/bn_act.cu: bn_act on tensors for which
    `takes_kernel` holds, which its callers have asked."""
    global launches
    shortcut = 0 if residual is None else 1 if residual_bn is None else 2  # identity, normed
    out = torch.empty_like(y)
    _, C, H, W = y.shape
    lib = library()
    rc = lib.parseq_bn_act(y.data_ptr(), None if residual is None else residual.data_ptr(),
                           out.data_ptr(), *_stats(bn), *_stats(residual_bn), shortcut,
                           y.numel(), C, H * W if y.is_contiguous() else 1,
                           y.dtype == torch.float32, bool(relu),
                           torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'bn_act kernel launch failed: cuda error {rc} '
                           f'({lib.parseq_bn_act_error_string(rc).decode()})')
    launches += 1
    return out


def _stats(bn):
    """The kernel's arguments for a batch norm: the addresses of its running
    mean and variance, weight and bias, and its eps (None and 0 without one)."""
    if bn is None:
        return None, None, None, None, 0.0
    return (bn.running_mean.data_ptr(), bn.running_var.data_ptr(), bn.weight.data_ptr(),
            bn.bias.data_ptr(), bn.eps)
