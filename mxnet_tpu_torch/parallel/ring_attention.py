"""Blockwise (flash) attention and its dense oracle (counterpart of
``mxnet_tpu/parallel/ring_attention.py``).

- :func:`attention_reference`: plain ``softmax(Q K^T) V``, the
  correctness oracle and the short-KV path of ``ops.contrib
  flash_attention``.
- :func:`blockwise_attention`: memory-efficient attention over key
  blocks, the flash-attention kernel (K3/K3') on a CUDA tensor and its
  plain version on a CPU tensor.

Causal masking is bottom-right aligned in both (query i attends keys
j <= i + S_kv - S_q); rows whose allowed set is empty come out as
zeros. Both are differentiable: the oracle by plain autograd, as JAX
differentiates it, and the blockwise path through the flash-attention
backward kernels (their plain version on a CPU tensor). Ring and Ulysses
attention over a mesh are not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import default_scale, flash_attention
from ..ops.tensor import shifted_expsum

__all__ = ["attention_reference", "blockwise_attention"]


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain ``softmax(Q K^T) V`` on ``[..., S, D]`` inputs: the scores
    in q's dtype, masked with the dtype's lowest value under ``causal``,
    the max-shifted exp and its row sum accumulated in fp32
    (``shifted_expsum``), the weights cast back to q's dtype."""
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    scores = torch.einsum("...qd,...kd->...qk", q, k) * scale
    mask = None
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    _, shifted, se32 = shifted_expsum(scores, axis=-1)
    w = (torch.exp(shifted).float() / se32).to(q.dtype)
    if mask is not None:
        w = w * mask.any(-1, keepdim=True).to(w.dtype)
    return torch.einsum("...qk,...kd->...qd", w, v)


def blockwise_attention(q, k, v, block_size=512, causal=False, scale=None):
    """Memory-efficient attention over key blocks (inputs ``[..., S,
    D]``): the flash-attention kernel on a CUDA tensor, its plain version
    (``_blockwise_impl``'s online softmax in fp32) on a CPU tensor.
    ``block_size`` is the plain version's key block, a perf knob."""
    return flash_attention(q, k, v, block_size=block_size, causal=causal,
                           scale=scale)
