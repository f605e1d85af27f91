"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``)."""
from __future__ import annotations

import torch

from .. import random as _random
from ..kernels import fused_conv_epilogue, fused_matmul_epilogue
from ..kernels.flash_attention import flash_attention_qkv
from ..parallel.ring_attention import attention_reference, blockwise_attention
from .tensor import shifted_expsum

__all__ = ["arange_like", "conv_epilogue", "flash_attention",
           "fused_self_attention", "matmul_epilogue"]

# above this many keys attention streams through the flash-attention
# kernel (K3/K3'); at or below it one dense softmax(QK^T)V is computed
DENSE_ATTENTION_MAX_KV = 1024


def conv_epilogue(x, res, act_type="relu"):
    """ref: ``_contrib_conv_epilogue`` — the residual epilogue
    ``act(x + res)`` in one pass: the conv-epilogue kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return fused_conv_epilogue(x, res=res, act_type=act_type)


def matmul_epilogue(y, bias, act_type=None, p=0.0, training=False,
                    generator=None):
    """ref: ``_contrib_matmul_epilogue`` — ``dropout(act(y + bias))`` in
    one pass over a matrix product's output, ``bias`` along the last
    axis: the matmul-epilogue kernel on a CUDA tensor, its plain version
    on a CPU tensor. Dropout engages only in training with ``p > 0``:
    one uint8 per element drawn on ``y``'s device from ``generator`` (the
    device's dropout generator when None), the counterpart of
    ``dropout_bits``. Differentiable."""
    if not training or p <= 0:
        return fused_matmul_epilogue(y, bias, act_type=act_type)
    bits = _random.bits(y.shape, y.device, generator)
    return fused_matmul_epilogue(y, bias, act_type=act_type, p=p, bits=bits)


def arange_like(x, start=0.0, step=1.0, repeat=1, axis=None):
    """ref: ``arange_like`` — ``start + step * i`` in ``x``'s dtype, over
    all of ``x`` (its shape) or along ``axis`` (a vector)."""
    n = x.numel() if axis is None else x.shape[axis]
    out = (start + step * torch.arange(n, device=x.device)).to(x.dtype)
    return out.reshape(x.shape) if axis is None else out


def flash_attention(q, k, v, block_size=512, causal=False, sm_scale=None):
    """ref: ``_contrib_flash_attention`` — attention on [B, H, S, D]
    inputs (3-D inputs ride as H = 1), scale ``D ** -0.5`` unless
    ``sm_scale`` is given, causal bottom-right. Up to
    ``DENSE_ATTENTION_MAX_KV`` keys it is the dense
    :func:`~..parallel.ring_attention.attention_reference`; above, the
    streaming :func:`~..parallel.ring_attention.blockwise_attention`
    (the flash-attention kernel on a CUDA tensor). Differentiable."""
    scale = float(q.shape[-1]) ** -0.5 if sm_scale is None else sm_scale
    if k.shape[-2] <= DENSE_ATTENTION_MAX_KV:
        return attention_reference(q, k, v, causal=causal, scale=scale)
    return blockwise_attention(q, k, v, block_size=block_size,
                               causal=causal, scale=scale)


def fused_self_attention(qkv, heads=None, causal=False, block_size=512):
    """ref: ``_contrib_fused_self_attention`` — self-attention straight
    off the fused QKV projection (B, S, 3C), q-major column blocks, in
    the (B, S, H, D) einsum layout. Up to ``DENSE_ATTENTION_MAX_KV``
    tokens: ``softmax(Q K^T / sqrt(D)) V`` with the max-shifted exp and
    its row sum accumulated in fp32, then a divide. Above: the
    flash-attention kernel reads the three column blocks of ``qkv`` in
    place as strided (B, S, H, D) views and writes (B, S, H, D), which is
    (B, S, C) without a copy (the JAX package transposes to [B, H, S, D]
    and back); its backward writes the gradient of ``qkv`` as one (B, S,
    3C) tensor through the same strides. The dense path is plain
    autograd."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    scale = float(d) ** -0.5
    if s > DENSE_ATTENTION_MAX_KV:
        return flash_attention_qkv(qkv, heads, block_size=block_size,
                                   causal=causal, scale=scale)
    q = qkv[:, :, :c].reshape(b, s, heads, d)
    k = qkv[:, :, c:2 * c].reshape(b, s, heads, d)
    v = qkv[:, :, 2 * c:].reshape(b, s, heads, d)
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
