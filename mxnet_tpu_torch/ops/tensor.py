"""Tensor operators (counterpart of ``mxnet_tpu/ops/tensor.py``)."""
from __future__ import annotations

import torch

__all__ = ["broadcast_like", "expand_dims", "flatten", "gather_nd",
           "log_softmax", "logsumexp", "pick", "shifted_expsum",
           "slice_like", "squeeze", "stack"]


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
