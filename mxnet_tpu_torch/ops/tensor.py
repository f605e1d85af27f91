"""Tensor operators (counterpart of ``mxnet_tpu/ops/tensor.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["broadcast_like", "concat", "expand_dims", "flatten", "gather_nd",
           "log_softmax", "logsumexp", "pad", "pick", "reshape",
           "reshape_like", "shifted_expsum", "slice_axis", "slice_like",
           "squeeze", "stack", "swapaxes"]


def flatten(x):
    """ref: Flatten — (N, d1, d2, ...) → (N, d1*d2*...)."""
    return x.reshape(x.shape[0], -1)


def expand_dims(x, axis=0):
    """ref: expand_dims."""
    return torch.unsqueeze(x, axis)


def squeeze(x, axis=None):
    """ref: squeeze — drop ``axis`` (an int or a tuple), or every axis of
    size 1."""
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(axis) if isinstance(axis, (list, tuple))
                         else axis)


def broadcast_like(x, like):
    """ref: broadcast_like — ``x`` broadcast to ``like``'s shape."""
    return torch.broadcast_to(x, like.shape)


def slice_like(x, like, axes=None):
    """ref: slice_like — the leading ``like.shape[a]`` entries of ``x``
    along each of ``axes`` (all axes when None)."""
    axes = axes if axes is not None else tuple(range(x.ndim))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(0, like.shape[a])
    return x[tuple(idx)]


def shifted_expsum(x, axis=-1):
    """The numerically stable exp-sum core: ``(m, shifted, se32)`` with
    ``m = max(x)`` (no gradient), ``shifted = x - m`` in ``x``'s dtype
    and ``se32 = sum(exp(shifted))`` accumulated in at least fp32. One
    definition backs the short-sequence attention softmax, as in the JAX
    package."""
    acc = torch.promote_types(x.dtype, torch.float32)   # fp64 stays fp64
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    shifted = x - m
    se32 = torch.sum(torch.exp(shifted).to(acc), dim=axis, keepdim=True)
    return m, shifted, se32


def logsumexp(x, axis=-1, keepdims=False):
    """ref: logsumexp — ``max + log(sum(exp(x - max)))`` with the sum in
    at least fp32 (the result is fp32 for lower-precision inputs); its
    gradient is the softmax. Backs the fused sparse softmax-CE loss."""
    m, _, se32 = shifted_expsum(x, axis=axis)
    out = m.to(se32.dtype) + torch.log(se32)
    return out if keepdims else torch.squeeze(out, axis)


def log_softmax(x, axis=-1):
    """ref: log_softmax — ``(x - max) - log(sum(exp(x - max)))``, the sum
    in at least fp32, the result in ``x``'s dtype."""
    _, shifted, se32 = shifted_expsum(x, axis=axis)
    return shifted - torch.log(se32).to(x.dtype)


def pick(x, index, axis=-1, keepdims=False):
    """ref: pick — one element per row along ``axis`` at ``index`` (cast
    to int32, clipped into the axis, as the JAX op clips)."""
    n = x.shape[axis]
    idx = index.to(torch.int32).long().clamp(0, n - 1).unsqueeze(axis)
    picked = torch.gather(x, axis, idx)
    return picked if keepdims else torch.squeeze(picked, axis)


def gather_nd(data, indices):
    """ref: gather_nd — ``indices`` (M, ...) index the leading M axes of
    ``data``. As in the JAX package, a negative index counts from the end
    and an index still outside the axis is clamped to it."""
    idx = []
    for i in range(indices.shape[0]):
        n = data.shape[i]
        ix = indices[i].to(torch.int32).long()
        ix = torch.where(ix < 0, ix + n, ix)
        idx.append(ix.clamp(0, n - 1))
    return data[tuple(idx)]


def stack(*args, axis=0):
    """ref: stack."""
    return torch.stack(args, dim=axis)


def concat(*args, dim=1, num_args=None):
    """ref: Concat — join along ``dim``."""
    return torch.cat(args, dim=dim)


def swapaxes(x, dim1=0, dim2=0):
    """ref: SwapAxis."""
    return torch.swapaxes(x, dim1, dim2)


def slice_axis(x, axis=0, begin=0, end=None):
    """ref: slice_axis — ``x[begin:end]`` along ``axis``."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


def reshape(x, shape=None, reverse=False):
    """ref: Reshape with MXNet's special codes, as the JAX op reads them:
    0 copies a dimension, -1 infers one, -2 copies the rest, -3 merges
    two, -4 splits one into the next two numbers (either may be -1);
    ``reverse`` reads both shapes from the right."""
    src = list(x.shape)
    shape = list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(int(s))
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return torch.reshape(x, tuple(out))


def reshape_like(lhs, rhs):
    """ref: reshape_like — ``lhs`` in ``rhs``'s shape."""
    return lhs.reshape(rhs.shape)


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


def pad(x, mode="constant", pad_width=None, constant_value=0.0):
    """ref: Pad — ``pad_width`` is MXNet's flat (before, after) pair per
    axis. ``constant`` pads any axis; ``edge`` and ``reflect`` pad at most
    the last three axes of a 2-D to 5-D input and none of its first two
    (PyTorch's replicate and reflect modes), as MXNet's op requires."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(x.ndim)]
    flat = [v for lo_hi in reversed(pw) for v in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, value=constant_value)
    if mode not in _PAD_MODES:
        raise MXNetError(f"Pad: unknown mode {mode!r}")
    padded = [i for i, p in enumerate(pw) if p != (0, 0)]
    if not padded:
        return x
    if x.ndim not in (3, 4, 5) or padded[0] < 2:
        raise MXNetError(f"Pad: mode {mode!r} pads the axes past the first "
                         f"two of a 3-D to 5-D input; got pad_width "
                         f"{tuple(pad_width)} for a {x.ndim}-D input")
    return F.pad(x, flat[:2 * (x.ndim - 2)], mode=_PAD_MODES[mode])
