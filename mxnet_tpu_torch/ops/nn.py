"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``).

Plain functions on tensors with the JAX package's op names, arguments
and NCHW/OIHW layouts. Convolution, pooling and the matrix product go to
PyTorch, as the JAX package leaves them to XLA; the BatchNorm + activation
epilogue goes to the hand-written conv-epilogue kernel. BatchNorm and
Dropout have both their predict and their training branch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..kernels import fused_conv_epilogue, keep_threshold

__all__ = ["activation", "batch_norm", "convolution", "ctc_loss",
           "deconvolution", "dropout", "embedding", "fully_connected",
           "group_norm", "instance_norm", "layer_norm", "leaky_relu",
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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconvolution(x, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True):
    """ref: Deconvolution — transposed N-D convolution, weight ``(in,
    out/groups, *kernel)`` (PyTorch's layout too). Output length per axis
    ``(i - 1)·stride - 2·pad + dilate·(k - 1) + 1 + adj``, as the JAX op
    computes it; like the JAX op, ``target_shape`` is accepted and not
    read. PyTorch takes ``adj`` as ``output_padding`` only below the
    stride or the dilation; any other ``adj`` (which the JAX op accepts)
    takes the full transposed convolution, cropped by ``pad`` on both
    sides and zero-extended at the end where ``adj`` passes it."""
    nd = len(kernel)
    if nd not in _CONV_T or x.ndim != nd + 2:
        raise MXNetError(f"Deconvolution: unsupported input ndim {x.ndim} "
                         f"for a {nd}-D kernel")
    stride = _pair(stride or 1, nd)
    dilate = _pair(dilate or 1, nd)
    pad = _pair(pad or 0, nd)
    adj = _pair(adj or 0, nd)
    b = None if no_bias else bias
    conv_t = _CONV_T[nd]
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        return conv_t(x, weight, b, stride=stride, padding=pad,
                      output_padding=adj, groups=num_group, dilation=dilate)
    full = conv_t(x, weight, b, stride=stride, groups=num_group,
                  dilation=dilate)
    for i in range(nd):
        axis = 2 + i
        length = full.shape[axis] - 2 * pad[i] + adj[i]
        lo = min(pad[i], full.shape[axis])
        kept = full.narrow(axis, lo, min(length, full.shape[axis] - lo))
        short = length - kept.shape[axis]
        if short > 0:
            tail = list(kept.shape)
            tail[axis] = short
            fill = torch.zeros(tail, dtype=kept.dtype, device=kept.device)
            if b is not None:
                fill = fill + b.reshape((1, -1) + (1,) * nd)
            kept = torch.cat([kept, fill], dim=axis)
        full = kept
    return full


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
    """ref: BatchNorm. Returns ``(out, mean, var)`` like the JAX op.

    Predict mode (or ``use_global_stats``) normalizes with the running
    statistics. Training normalizes with the batch's, term for term as
    the JAX op: one-pass fp32 moments of ``x - c`` about ``c``, the
    running mean taken as a constant; ``var = maximum(e2 - mean_c², 0)``
    (``torch.maximum``, whose gradient splits a tie as ``jnp.maximum``'s
    does); channels whose variance cancellation destroyed (``e2 > 4096 ·
    var``) normalize with ``e2`` instead, and the biased ``var`` is
    reported either way. This is not ``torch.nn.functional.batch_norm``,
    which keeps an unbiased running variance with the complementary
    momentum and no shift. The running statistics are not touched here:
    the Gluon layer folds the returned mean and var into them.

    Mean, var, gamma and beta fold in fp32 into a per-channel scale and
    offset, cast once to ``x``'s dtype; with ``act_type`` the
    multiply-add and the activation run as one conv-epilogue pass."""
    ax = axis % x.ndim
    bshape = [1] * x.ndim
    bshape[ax] = x.shape[ax]
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if training and not use_global_stats:
        # no op below saves the shift for backward (sub and add save
        # nothing), so the layer may update the buffer in place
        axes = tuple(i for i in range(x.ndim) if i != ax)
        c = moving_mean.detach().float()
        xc = x.float() - c.reshape(bshape)
        mean_c = torch.mean(xc, dim=axes)
        e2 = torch.mean(torch.square(xc), dim=axes)
        d = e2 - torch.square(mean_c)
        var_raw = torch.maximum(d, d.new_zeros(()))
        mean = mean_c + c
        suspicious = e2 > 4096.0 * torch.clamp(var_raw.detach(), min=1e-30)
        var_norm = torch.where(suspicious, e2, var_raw)
        var = var_raw
    else:
        mean = moving_mean.float()
        var = moving_var.float()
        var_norm = var
    scale = torch.rsqrt(var_norm + eps) * gamma.float()
    offset = beta.float() - mean * scale
    if act_type is None:
        out = x * scale.to(x.dtype).reshape(bshape) \
            + offset.to(x.dtype).reshape(bshape)
    else:
        out = fused_conv_epilogue(
            x, scale=scale.to(x.dtype), bias=offset.to(x.dtype),
            channel_axis=ax, act_type=act_type)
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    """ref: LeakyReLU — the leaky, prelu (learned slope ``gamma``, one per
    channel of axis 1), elu, selu, gelu (exact erf) and rrelu modes, as
    the JAX op: ``x >= 0`` takes the positive branch, and rrelu's slope is
    the middle of its bounds."""
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "selu":
        return _SELU_SCALE * torch.where(x > 0, x,
                                         _SELU_ALPHA * torch.expm1(x))
    if act_type == "leaky":
        neg = slope * x
    elif act_type == "prelu":
        if gamma.ndim == 1 and x.ndim > 1:
            gamma = gamma.reshape((1, -1) + (1,) * (x.ndim - 2))
        neg = gamma * x
    elif act_type == "elu":
        neg = slope * torch.expm1(x)
    elif act_type == "rrelu":
        neg = (lower_bound + upper_bound) / 2.0 * x
    else:
        raise MXNetError(f"LeakyReLU: unknown act_type {act_type!r}")
    return torch.where(x >= 0, x, neg)


def _moments_acc(x, axis):
    """Centered two-pass mean and variance along ``axis``, accumulated
    in at least fp32 (fp64 stays fp64), as the JAX package's
    ``_moments_acc``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = torch.mean(xf, dim=axis, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axis, keepdim=True)
    return mean, var


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """ref: LayerNorm — two-pass fp32 moments, normalize in ``x``'s
    dtype, then ``* gamma + beta`` along ``axis``."""
    mean, var = _moments_acc(x, axis)
    inv = torch.rsqrt(var + eps)
    bshape = [1] * x.ndim
    bshape[axis % x.ndim] = x.shape[axis % x.ndim]
    out = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """ref: GroupNorm — moments over each group of ``num_groups`` channel
    groups and the spatial axes (two-pass, at least fp32), normalize in
    ``x``'s dtype, then ``* gamma + beta`` per channel."""
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    mean, var = _moments_acc(xg, tuple(range(2, xg.ndim)))
    xg = (xg - mean.to(xg.dtype)) * torch.rsqrt(var + eps).to(xg.dtype)
    bshape = (1, c) + (1,) * (x.ndim - 2)
    return xg.reshape(x.shape) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


def instance_norm(x, gamma, beta, eps=1e-3):
    """ref: InstanceNorm — per sample and channel over the spatial axes."""
    mean, var = _moments_acc(x, tuple(range(2, x.ndim)))
    out = (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    bshape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def dropout(x, p=0.5, mode="training", axes=(), training=False,
            bits=None, generator=None):
    """ref: Dropout, inverted. Outside training (and without
    ``mode="always"``) or with ``p <= 0`` it is the identity. Otherwise,
    as the JAX op: one uint8 per element (size 1 along ``axes``, which
    broadcast), kept where ``bits >= keep_threshold(p)``, and ``x / (1 -
    p)`` where kept, 0 elsewhere. ``bits`` are drawn on ``x``'s device
    from ``generator`` (the device's dropout generator when None) unless
    given."""
    if p <= 0 or (not training and mode != "always"):
        return x
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    if bits is None:
        bits = _random.bits(shape, x.device, generator)
    elif list(bits.shape) != shape or bits.dtype != torch.uint8:
        raise MXNetError(f"Dropout: bits {tuple(bits.shape)} {bits.dtype} "
                         f"must be uint8 of {tuple(shape)}")
    keep = bits >= keep_threshold(p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def embedding(indices, weight, input_dim=None, output_dim=None):
    """ref: Embedding — rows of ``weight`` at ``indices`` (cast to int32).
    As the JAX package's ``jnp.take``: an id in [-V, -1] counts from the
    end, and an id >= V or < -V gives a row of NaN (never an error or a
    device-side assert)."""
    v = weight.shape[0]
    ids = indices.to(torch.int32).long()
    ids = torch.where(ids < 0, ids + v, ids)
    inside = (ids >= 0) & (ids < v)
    rows = weight[ids.clamp(0, v - 1)]
    return torch.where(inside.unsqueeze(-1), rows,
                       torch.full((), math.nan, dtype=rows.dtype,
                                  device=rows.device))


_CTC_NEG = -1e30                     # the JAX op's "log 0"


def _ctc_alpha(logp, ext, t_mask, s_len):
    """The CTC forward (alpha) recursion in log space over time, as the
    JAX op's ``lax.scan``: ``logp`` (T, N, C), ``ext`` (N, S) the
    blank-interleaved labels (blank C - 1), ``t_mask`` (T, N) the valid
    steps, ``s_len`` (N,) the valid extended length. Returns -log p."""
    T, N, C = logp.shape
    S = ext.shape[1]
    neg = torch.full((), _CTC_NEG, dtype=logp.dtype, device=logp.device)
    emit = torch.gather(logp, 2, ext.unsqueeze(0).expand(T, N, S))
    can_skip = torch.cat([torch.zeros(N, 2, dtype=torch.bool,
                                      device=ext.device),
                          (ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != C - 1)],
                         dim=1)
    alpha = torch.cat([emit[0, :, :1],
                       torch.where(s_len[:, None] > 1, emit[0, :, 1:2], neg),
                       neg.expand(N, S - 2)], dim=1)
    for t in range(1, T):
        shift1 = torch.cat([neg.expand(N, 1), alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat(
            [neg.expand(N, 2), alpha[:, :-2]], dim=1), neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) \
            + emit[t]
        alpha = torch.where(t_mask[t][:, None], merged, alpha)
    last = torch.gather(alpha, 1, (s_len - 1)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, torch.clamp(s_len - 2, min=0)[:, None])[:, 0]
    return -torch.logaddexp(last, torch.where(s_len > 1, last2, neg))


def ctc_loss(data, labels, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="last"):
    """ref: CTCLoss — -log p(label | data) per sample, as the JAX op.
    ``data`` (T, N, C) are activations (log-softmax taken here),
    ``labels`` (N, L). ``blank_label`` "last" makes class C - 1 the blank,
    "first" class 0 (the classes and labels shift down by one). Without
    ``label_lengths`` a label counts where it is >= 0 and not the blank
    (padding at the end); without ``data_lengths`` every step counts.
    With no labels (L = 0) the only path is all blanks. An impossible
    alignment costs about 1e30, the JAX op's "log 0", not inf."""
    T, N, C = data.shape
    if use_data_lengths and data_lengths is None:
        raise MXNetError("CTCLoss: use_data_lengths without data_lengths")
    if use_label_lengths and label_lengths is None:
        raise MXNetError("CTCLoss: use_label_lengths without label_lengths")
    dev = data.device
    t_len = torch.full((N,), T, dtype=torch.int64, device=dev) \
        if data_lengths is None else data_lengths.to(dev).to(
            torch.int32).long()
    t_mask = torch.arange(T, device=dev)[:, None] < t_len[None, :]
    logp = torch.log_softmax(data, dim=2)
    if labels.shape[1] == 0:
        blank0 = C - 1 if blank_label == "last" else 0
        return -torch.sum(torch.where(t_mask, logp[:, :, blank0],
                                      logp.new_zeros(())), dim=0)
    labels = labels.to(dev).to(torch.int32).long()
    if blank_label != "last":
        logp = torch.cat([logp[:, :, 1:], logp[:, :, :1]], dim=2)
        labels = labels - 1
    if label_lengths is None:
        label_len = torch.sum((labels >= 0) & (labels < C - 1), dim=1)
    else:
        label_len = label_lengths.to(dev).to(torch.int32).long()
    L = labels.shape[1]
    ext = torch.full((N, 2 * L + 1), C - 1, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.clamp(0, C - 1)
    return _ctc_alpha(logp, ext, t_mask, 2 * label_len + 1)
