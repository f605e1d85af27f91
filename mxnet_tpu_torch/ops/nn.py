"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``).

Plain functions on tensors with the JAX package's op names, arguments
and NCHW/OIHW layouts. Convolution, pooling and the matrix product go to
PyTorch, as the JAX package leaves them to XLA; the BatchNorm + activation
epilogue goes to the hand-written conv-epilogue kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..kernels import fused_conv_epilogue

__all__ = ["activation", "batch_norm", "convolution", "fully_connected",
           "pooling"]


def _pair(v, n):
    v = tuple(v) if not isinstance(v, int) else (v,) * n
    if len(v) == 1:
        v = v * n
    return v


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """ref: FullyConnected — ``y = x W^T + b``."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.t())
    if not no_bias:
        y = y + bias
    return y


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def convolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False):
    """ref: Convolution — N-D convolution, NCHW/OIHW layouts."""
    nd = len(kernel)
    if nd not in _CONV or x.ndim != nd + 2:
        raise MXNetError(f"Convolution: unsupported input ndim {x.ndim} "
                         f"for a {nd}-D kernel")
    return _CONV[nd](x, weight, None if no_bias else bias,
                     stride=_pair(stride or 1, nd),
                     padding=_pair(pad or 0, nd),
                     dilation=_pair(dilate or 1, nd), groups=num_group)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _sum_pool(x, kernel, stride):
    """Window sums with no padding (avg_pool with a divisor of 1)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-1), (kernel[0], 1), (stride[0], 1),
                            divisor_override=1).squeeze(-1)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def pooling(x, kernel=(), pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True):
    """ref: Pooling — max/avg pooling and global pooling. Padding is
    explicit (-inf for max, 0 for avg), with the extra right padding of
    the ``full`` (ceil) convention, exactly as the JAX op pads."""
    nd = x.ndim - 2
    if global_pool:
        axes = tuple(range(2, x.ndim))
        if pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        if pool_type == "avg":
            return torch.mean(x, dim=axes, keepdim=True)
        raise MXNetError(f"Pooling: unknown global pool_type {pool_type!r}")
    if nd not in _MAX_POOL:
        raise MXNetError(f"Pooling: unsupported input ndim {x.ndim}")
    kernel = _pair(kernel, nd)
    stride = _pair(stride or 1, nd)
    pad = _pair(pad or 0, nd)
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(nd):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            hi[i] += (stride[i] - rem) % stride[i] if rem else 0
    pads = []                      # F.pad lists the last axis first
    for i in reversed(range(nd)):
        pads += [pad[i], hi[i]]
    if pool_type == "max":
        xp = F.pad(x, pads, value=-math.inf) if any(pads) else x
        return _MAX_POOL[nd](xp, kernel, stride)
    if pool_type != "avg":
        raise MXNetError(f"Pooling: unknown pool_type {pool_type!r}")
    summed = _sum_pool(F.pad(x, pads) if any(pads) else x, kernel, stride)
    if count_include_pad:
        return summed / float(math.prod(kernel))
    ones = torch.ones_like(x)
    counts = _sum_pool(F.pad(ones, pads) if any(pads) else ones, kernel,
                       stride)
    return summed / counts


def activation(x, act_type=None):
    """ref: Activation."""
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "relu6":
        return torch.clamp(x, 0, 6)
    raise MXNetError(f"Activation: unknown act_type {act_type!r}")


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, act_type=None, training=False):
    """ref: BatchNorm, inference branch: normalize with the running
    statistics. Returns ``(out, mean, var)`` like the JAX op.

    Mean, var, gamma and beta fold in fp32 into a per-channel scale and
    offset, cast once to ``x``'s dtype; with ``act_type`` the
    multiply-add and the activation run as one conv-epilogue pass."""
    if training and not use_global_stats:
        raise MXNetError("BatchNorm: the training branch (batch "
                         "statistics) is not ported yet; run in predict "
                         "mode or with use_global_stats=True")
    ax = axis % x.ndim
    bshape = [1] * x.ndim
    bshape[ax] = x.shape[ax]
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    mean = moving_mean.float()
    var = moving_var.float()
    scale = torch.rsqrt(var + eps) * gamma.float()
    offset = beta.float() - mean * scale
    if act_type is None:
        out = x * scale.to(x.dtype).reshape(bshape) \
            + offset.to(x.dtype).reshape(bshape)
    else:
        out = fused_conv_epilogue(
            x, scale=scale.to(x.dtype), bias=offset.to(x.dtype),
            channel_axis=ax, act_type=act_type)
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
