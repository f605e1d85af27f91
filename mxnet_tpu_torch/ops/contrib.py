"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``)."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..kernels import fused_conv_epilogue, fused_matmul_epilogue
from .tensor import shifted_expsum

__all__ = ["arange_like", "conv_epilogue", "fused_self_attention",
           "matmul_epilogue"]

# above this many keys the JAX package streams attention through its
# flash-attention kernels (K3 / K3'), which the port does not have yet
DENSE_ATTENTION_MAX_KV = 1024


def conv_epilogue(x, res, act_type="relu"):
    """ref: ``_contrib_conv_epilogue`` — the residual epilogue
    ``act(x + res)`` in one pass: the conv-epilogue kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return fused_conv_epilogue(x, res=res, act_type=act_type)


def matmul_epilogue(y, bias, act_type=None, p=0.0, training=False):
    """ref: ``_contrib_matmul_epilogue`` — ``dropout(act(y + bias))`` in
    one pass over a matrix product's output, ``bias`` along the last
    axis: the matmul-epilogue kernel on a CUDA tensor, its plain version
    on a CPU tensor. Dropout engages only in training, whose mask the
    port does not draw yet, so training with ``p > 0`` raises."""
    if training and p > 0:
        raise MXNetError("matmul_epilogue: dropout in training (a random "
                         "mask) is not ported yet; run in predict mode")
    return fused_matmul_epilogue(y, bias, act_type=act_type)


def arange_like(x, start=0.0, step=1.0, repeat=1, axis=None):
    """ref: ``arange_like`` — ``start + step * i`` in ``x``'s dtype, over
    all of ``x`` (its shape) or along ``axis`` (a vector)."""
    n = x.numel() if axis is None else x.shape[axis]
    out = (start + step * torch.arange(n, device=x.device)).to(x.dtype)
    return out.reshape(x.shape) if axis is None else out


def fused_self_attention(qkv, heads=None, causal=False, block_size=512):
    """ref: ``_contrib_fused_self_attention`` — self-attention straight
    off the fused QKV projection (B, S, 3C), q-major column blocks, in
    the (B, S, H, D) einsum layout: ``softmax(Q K^T / sqrt(D)) V`` with
    the max-shifted exp and its row sum accumulated in fp32, then a
    divide. For S above 1024 the JAX package streams through its flash
    attention kernel (K3), which is not ported yet: that raises."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if s > DENSE_ATTENTION_MAX_KV:
        raise MXNetError(
            f"fused_self_attention: S={s} > {DENSE_ATTENTION_MAX_KV} needs "
            "the flash-attention kernel K3 (mxnet_tpu/ops/contrib.py "
            "_flash_attention), which is not ported yet")
    q = qkv[:, :, :c].reshape(b, s, heads, d)
    k = qkv[:, :, c:2 * c].reshape(b, s, heads, d)
    v = qkv[:, :, 2 * c:].reshape(b, s, heads, d)
    scale = float(d) ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qi = torch.arange(s, device=qkv.device)[:, None]
        ki = torch.arange(s, device=qkv.device)[None, :]
        scores = torch.where(qi >= ki, scores,
                             torch.finfo(scores.dtype).min)
    _, shifted, se32 = shifted_expsum(scores, axis=-1)
    att = (torch.exp(shifted).float() / se32).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v)
    return out.reshape(b, s, c)
