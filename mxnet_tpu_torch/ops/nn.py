"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``).

Plain functions on tensors with the JAX package's op names, arguments
and NCHW/OIHW layouts. Convolution, pooling and the matrix product go to
PyTorch, as the JAX package leaves them to XLA; the BatchNorm + activation
epilogue goes to the hand-written conv-epilogue kernel. BatchNorm and
Dropout have both their predict and their training branch. The loss
heads ``SoftmaxOutput``, the three regression outputs and ``MakeLoss``
keep MXNet's own backward, which ignores the head gradient
(``torch.autograd.Function``s). The 28 names of the JAX package's
``ops/nn.py`` but ``RNN`` (ROADMAP Queue 1 item 7b) are registered.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError, jax_dtype
from ..kernels import fused_conv_epilogue, keep_threshold

__all__ = ["activation", "batch_norm", "convolution", "ctc_loss",
           "deconvolution", "dropout", "embedding", "fully_connected",
           "group_norm", "instance_norm", "l2_normalization", "layer_norm",
           "leaky_relu", "make_loss", "pooling", "rms_norm", "smooth_l1",
           "softmax", "softmax_activation", "softmax_output", "softmin",
           "upsampling"]


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
    """ref: Pooling — max, avg, sum and lp (p = 2) pooling and global
    pooling (max, else the mean, as the JAX op). Padding is
    explicit (-inf for max, 0 for avg), with the extra right padding of
    the ``full`` (ceil) convention, exactly as the JAX op pads."""
    nd = x.ndim - 2
    if global_pool:
        axes = tuple(range(2, x.ndim))
        if pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        return torch.mean(x, dim=axes, keepdim=True)
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
    if pool_type == "lp":                    # p = 2, as the JAX op
        xp = F.pad(x, pads) if any(pads) else x
        return torch.sqrt(_sum_pool(torch.square(torch.abs(xp)), kernel,
                                    stride))
    if pool_type not in ("avg", "sum"):
        raise MXNetError(f"Pooling: unknown pool_type {pool_type!r}")
    summed = _sum_pool(F.pad(x, pads) if any(pads) else x, kernel, stride)
    if pool_type == "sum":
        return summed
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


def _sparse_embedding(indices, weight):
    """:func:`embedding` with a row-sparse weight gradient
    (``ndarray.sparse.sparse_embedding``)."""
    from ..ndarray.sparse import sparse_embedding
    return sparse_embedding(indices, weight)


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


# ---------------------------------------------------------------------------
# The rest of the JAX package's nn names and the registry entries.
# ---------------------------------------------------------------------------
def softmax(x, axis=-1, temperature=None, length=None, dtype=None):
    """ref: softmax — over ``axis``, ``x / temperature`` first when given;
    ``length`` is accepted and not read, as in the JAX op."""
    if temperature:
        x = x / temperature
    out = torch.softmax(x, dim=axis)
    return out.to(jax_dtype(dtype)) if dtype else out


def softmin(x, axis=-1):
    """ref: softmin — softmax of ``-x``."""
    return torch.softmax(-x, dim=axis)


def softmax_activation(x, mode="instance"):
    """ref: SoftmaxActivation — over the channels (``channel``) or over all
    of a sample's values (``instance``)."""
    if mode == "channel":
        return torch.softmax(x, dim=1)
    flat = x.reshape(x.shape[0], math.prod(x.shape[1:]))
    return torch.softmax(flat, dim=-1).reshape(x.shape)


def l2_normalization(x, eps=1e-10, mode="instance"):
    """ref: L2Normalization — ``x / sqrt(sum(x^2) + eps)`` per sample
    (``instance``), per position over the channels (``channel``) or per
    channel over the spatial axes (``spatial``)."""
    if mode == "instance":
        norm = torch.sqrt(torch.sum(torch.square(x.reshape(x.shape[0], -1)),
                                    dim=1) + eps)
        return x / norm.reshape((-1,) + (1,) * (x.ndim - 1))
    if mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.ndim))
    else:
        raise MXNetError(f"L2Normalization: unknown mode {mode!r}")
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                          + eps)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """ref: RMSNorm — ``x * rsqrt(mean(x^2) + eps) * gamma``."""
    ms = torch.mean(torch.square(x), dim=axis, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


def upsampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """ref: UpSampling — nearest only (bilinear is
    ``contrib.BilinearResize2D``), each pixel repeated ``scale`` times
    along H and W."""
    if sample_type != "nearest":
        raise MXNetError("UpSampling: only nearest supported; use "
                         "contrib.BilinearResize2D for bilinear")
    x = args[0]
    return torch.repeat_interleave(torch.repeat_interleave(x, scale, dim=2),
                                   scale, dim=3)


def smooth_l1(x, scalar=1.0):
    """ref: smooth_l1 — ``0.5 (s x)^2`` where ``|x| < 1/s^2``, else ``|x| -
    0.5/s^2``."""
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the last axis; backward ``(out - onehot(label)) *
    grad_scale`` (masked where ``label == ignore_label`` with
    ``use_ignore``), the head gradient ignored: a terminal loss op (JAX
    ``_softmax_output_core``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, ignore_label, use_ignore)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore = ctx.args
        from .tensor import one_hot
        grad = (out - one_hot(label, out.shape[-1]).to(out.dtype)) \
            * grad_scale
        if use_ignore:
            grad = grad * (label != ignore_label).to(out.dtype).unsqueeze(-1)
        return grad, torch.zeros_like(label), None, None, None


def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """ref: SoftmaxOutput — softmax forward, cross-entropy backward. As
    the JAX op: ``multi_output`` takes the softmax over axis 1 at each
    position; a >2-D input otherwise flattens its trailing axes unless
    ``preserve_shape``; ``normalization``, ``out_grad`` and
    ``smooth_alpha`` are accepted and not read."""
    orig_shape = data.shape
    if multi_output and data.ndim > 2:
        d2 = torch.movedim(data, 1, -1)
        out = _SoftmaxOutput.apply(d2.reshape(-1, d2.shape[-1]),
                                   label.reshape(-1).to(data.dtype),
                                   grad_scale, ignore_label, use_ignore)
        return torch.movedim(out.reshape(d2.shape), -1, 1)
    if data.ndim > 2 and not preserve_shape:
        data = data.reshape(data.shape[0], -1)
    return _SoftmaxOutput.apply(data, label.to(data.dtype), grad_scale,
                                ignore_label, use_ignore).reshape(orig_shape)


class _Regression(torch.autograd.Function):
    """``link(data)`` forward; backward ``grad_fn(out, label) * grad_scale
    / n`` (n = out's axis 1, 1 for 1-D), the head gradient ignored (JAX
    ``_regression_core``)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.args
        diff = out - label.reshape(out.shape)
        if kind == "mae":
            diff = torch.sign(diff)
        n = out.shape[1] if out.ndim > 1 else 1
        return diff * grad_scale / n, torch.zeros_like(label), None, None


def _regression(kind):
    def fn(data, label, grad_scale=1.0):
        return _Regression.apply(data, label.to(data.dtype), grad_scale,
                                 kind)
    fn.__doc__ = (f"ref: {kind} regression output (regression_output.cc)")
    return fn


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward ``grad_scale`` everywhere, the head
    gradient ignored (JAX ``_make_loss``)."""

    @staticmethod
    def forward(ctx, x, grad_scale):
        ctx.grad_scale = grad_scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


def make_loss(x, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """ref: MakeLoss — marks ``x`` as a loss (``valid_thresh`` and
    ``normalization`` are accepted and not read, as in the JAX op)."""
    return _MakeLoss.apply(x, grad_scale)


def _register_all():
    from .registry import OpParam, register
    from .tensor import log_softmax

    register("FullyConnected", num_inputs=-1,
             params=[OpParam("num_hidden", int, None, required=True),
                     OpParam("no_bias", bool, False),
                     OpParam("flatten", bool, True)])(
        lambda x, weight, *bias, **p: fully_connected(
            x, weight, bias[0] if bias else None, **p))
    conv = [OpParam("kernel", tuple, None, required=True),
            OpParam("stride", tuple, None), OpParam("dilate", tuple, None),
            OpParam("pad", tuple, None),
            OpParam("num_filter", int, None, required=True),
            OpParam("num_group", int, 1)]
    ignored = [OpParam("layout", str, None), OpParam("cudnn_tune", str, None),
               OpParam("cudnn_off", bool, False),
               OpParam("workspace", int, 1024)]

    def drop(p, names=("layout", "cudnn_tune", "cudnn_off", "workspace")):
        return {k: v for k, v in p.items() if k not in names}

    register("Convolution", num_inputs=-1,
             params=conv + [OpParam("no_bias", bool, False)] + ignored)(
        lambda x, weight, *bias, **p: convolution(
            x, weight, bias[0] if bias else None, **drop(p)))
    register("Deconvolution", num_inputs=-1,
             params=conv[:4] + [OpParam("adj", tuple, None)] + conv[4:] + [
                 OpParam("no_bias", bool, True), OpParam("layout", str, None),
                 OpParam("workspace", int, 1024),
                 OpParam("cudnn_tune", str, None),
                 OpParam("cudnn_off", bool, False),
                 OpParam("target_shape", tuple, None)])(
        lambda x, weight, *bias, **p: deconvolution(
            x, weight, bias[0] if bias else None, **drop(p)))
    register("Pooling",
             params=[OpParam("kernel", tuple, ()),
                     OpParam("pool_type", str, "max"),
                     OpParam("global_pool", bool, False),
                     OpParam("stride", tuple, None),
                     OpParam("pad", tuple, None),
                     OpParam("pooling_convention", str, "valid"),
                     OpParam("count_include_pad", bool, True),
                     OpParam("cudnn_off", bool, False),
                     OpParam("layout", str, None)])(
        lambda x, **p: pooling(x, **drop(p)))
    register("Activation",
             params=[OpParam("act_type", str, None, required=True)])(
        activation)
    register("LeakyReLU", num_inputs=-1,
             params=[OpParam("act_type", str, "leaky"),
                     OpParam("slope", float, 0.25),
                     OpParam("lower_bound", float, 0.125),
                     OpParam("upper_bound", float, 0.334)])(
        lambda x, *gamma, **p: leaky_relu(x, gamma[0] if gamma else None,
                                          **p))
    register("softmax", params=[OpParam("axis", int, -1),
                                OpParam("temperature", float, None),
                                OpParam("length", tuple, None),
                                OpParam("dtype", str, None)])(softmax)

    def _log_softmax(x, axis=-1, temperature=None):
        return log_softmax(x / temperature if temperature else x, axis)

    register("log_softmax", params=[OpParam("axis", int, -1),
                                    OpParam("temperature", float, None)])(
        _log_softmax)
    register("softmin", params=[OpParam("axis", int, -1)])(softmin)
    register("SoftmaxActivation",
             params=[OpParam("mode", str, "instance")])(softmax_activation)
    bn = [OpParam("eps", float, 1e-3), OpParam("momentum", float, 0.9),
          OpParam("fix_gamma", bool, True),
          OpParam("use_global_stats", bool, False),
          OpParam("output_mean_var", bool, False), OpParam("axis", int, 1),
          OpParam("cudnn_off", bool, False)]

    def _batch_norm(x, gamma, beta, mean, var, output_mean_var=False,
                    cudnn_off=False, **p):
        return batch_norm(x, gamma, beta, mean, var, **p)

    register("BatchNorm", num_inputs=5, num_outputs=3, needs_mode=True,
             params=bn + [OpParam("act_type", str, None,
                                  doc="an activation fused into the "
                                      "normalize pass: the conv-epilogue "
                                      "kernel (K1) on a CUDA tensor")],
             doc="Batch normalization; outputs (out, batch mean, batch "
                 "var), as the JAX op")(_batch_norm)

    def _bn_relu(x, gamma, beta, mean, var, **p):
        out, m, v = _batch_norm(x, gamma, beta, mean, var, **p)
        return torch.maximum(out, out.new_zeros(())), m, v

    register("_contrib_BatchNormWithReLU", aliases=["BatchNormWithReLU"],
             num_inputs=5, num_outputs=3, needs_mode=True, params=bn,
             doc="BatchNorm, then max(., 0) (ref: batch_norm_relu.cc); no "
                 "kernel, as in the JAX package")(_bn_relu)
    register("LayerNorm", num_inputs=3,
             params=[OpParam("axis", int, -1), OpParam("eps", float, 1e-5),
                     OpParam("output_mean_var", bool, False)])(
        lambda x, g, b, output_mean_var=False, **p: layer_norm(x, g, b, **p))
    register("GroupNorm", num_inputs=3,
             params=[OpParam("num_groups", int, 1),
                     OpParam("eps", float, 1e-5)])(group_norm)
    register("InstanceNorm", num_inputs=3,
             params=[OpParam("eps", float, 1e-3)])(instance_norm)
    register("L2Normalization",
             params=[OpParam("eps", float, 1e-10),
                     OpParam("mode", str, "instance")])(l2_normalization)
    register("RMSNorm", num_inputs=2,
             params=[OpParam("axis", int, -1), OpParam("eps", float, 1e-6)])(
        rms_norm)
    register("Dropout", needs_rng=True, needs_mode=True,
             params=[OpParam("p", float, 0.5),
                     OpParam("mode", str, "training"),
                     OpParam("axes", tuple, ())])(
        lambda x, generator=None, **p: dropout(x, generator=generator, **p))
    register("Embedding", num_inputs=2,
             params=[OpParam("input_dim", int, None, required=True),
                     OpParam("output_dim", int, None, required=True),
                     OpParam("dtype", str, "float32"),
                     OpParam("sparse_grad", bool, False,
                             doc="the weight's gradient row-sparse (the "
                                 "touched rows) where autograd records "
                                 "it eagerly")])(
        lambda idx, w, input_dim=None, output_dim=None, dtype="float32",
        sparse_grad=False: _sparse_embedding(idx, w) if sparse_grad
        else embedding(idx, w, input_dim, output_dim))
    register("SoftmaxOutput", num_inputs=2,
             params=[OpParam("grad_scale", float, 1.0),
                     OpParam("ignore_label", float, -1.0),
                     OpParam("multi_output", bool, False),
                     OpParam("use_ignore", bool, False),
                     OpParam("preserve_shape", bool, False),
                     OpParam("normalization", str, "null"),
                     OpParam("out_grad", bool, False),
                     OpParam("smooth_alpha", float, 0.0)])(softmax_output)
    scale = [OpParam("grad_scale", float, 1.0)]
    register("LinearRegressionOutput", num_inputs=2, params=scale)(
        _regression("linear"))
    register("MAERegressionOutput", num_inputs=2, params=scale)(
        _regression("mae"))
    register("LogisticRegressionOutput", num_inputs=2, params=scale)(
        _regression("logistic"))
    register("MakeLoss", params=scale + [
        OpParam("valid_thresh", float, 0.0),
        OpParam("normalization", str, "null")])(make_loss)
    register("smooth_l1", params=[OpParam("scalar", float, 1.0)])(smooth_l1)
    register("UpSampling", num_inputs=-1,
             params=[OpParam("scale", int, 1, required=True),
                     OpParam("sample_type", str, "nearest"),
                     OpParam("num_args", int, 1),
                     OpParam("num_filter", int, 0),
                     OpParam("multi_input_mode", str, "concat"),
                     OpParam("workspace", int, 512)])(upsampling)

    def _ctc(data, labels, *lens, use_data_lengths=False,
             use_label_lengths=False, blank_label="last", data_lengths=None,
             label_lengths=None):
        lens = list(lens)
        if use_data_lengths and data_lengths is None:
            data_lengths = lens.pop(0)
        if use_label_lengths and label_lengths is None:
            label_lengths = lens.pop(0)
        # lengths may come as parameters holding arrays (the reference's
        # calling convention)
        dl, ll = (None if v is None else
                  torch.as_tensor(getattr(v, "_data", v), device=data.device)
                  for v in (data_lengths, label_lengths))
        return ctc_loss(data, labels, dl, ll, use_data_lengths=dl is not None,
                        use_label_lengths=ll is not None,
                        blank_label=blank_label)

    register("CTCLoss", num_inputs=-1, aliases=["ctc_loss", "_contrib_CTCLoss"],
             params=[OpParam("use_data_lengths", bool, False),
                     OpParam("use_label_lengths", bool, False),
                     OpParam("blank_label", str, "last"),
                     OpParam("data_lengths", None, None),
                     OpParam("label_lengths", None, None)])(_ctc)


_register_all()
