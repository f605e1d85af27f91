"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``).

Three reach the hand-written kernels on a CUDA tensor: ``conv_epilogue``
(K1), ``matmul_epilogue`` (K2) and ``flash_attention`` /
``fused_self_attention`` above 1024 keys (K3). The rest are plain
PyTorch, as the JAX package's are jnp. The detection operators (ROADMAP
Queue 1 item 10), the binary and quantized ones (item 12), ring and
Ulysses attention (item 9) and ``fused_cross_attention`` (item 7c) are
the registry's ``DEFERRED`` names.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..kernels import fused_conv_epilogue, fused_matmul_epilogue
from ..kernels.flash_attention import flash_attention_qkv
from .tensor import shifted_expsum

__all__ = ["adaptive_avg_pool_2d", "allclose", "arange_like",
           "bilinear_resize_2d", "boolean_mask", "conv_epilogue",
           "count_sketch", "div_sqrt_dim", "fft", "flash_attention",
           "fused_self_attention", "ifft", "index_copy",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "matmul_epilogue",
           "quadratic"]

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
    from ..parallel.ring_attention import (attention_reference,
                                           blockwise_attention)
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


def div_sqrt_dim(x):
    """ref: ``_contrib_div_sqrt_dim`` — ``x / sqrt(x.shape[-1])``."""
    return x / math.sqrt(float(x.shape[-1]))


def interleaved_matmul_selfatt_qk(qkv, heads=None):
    """ref: ``_contrib_interleaved_matmul_selfatt_qk`` — (T, N, 3E)
    interleaved per head as (q, k, v): ``q k^T / sqrt(D)`` as (N*H, T,
    T), one batched product."""
    t, n, e3 = qkv.shape
    hd = e3 // 3 // heads
    qkv = qkv.reshape(t, n, heads, 3, hd)
    q = qkv[:, :, :, 0].permute(1, 2, 0, 3).reshape(n * heads, t, hd)
    k = qkv[:, :, :, 1].permute(1, 2, 0, 3).reshape(n * heads, t, hd)
    return torch.matmul(q, k.transpose(1, 2)) / math.sqrt(float(hd))


def interleaved_matmul_selfatt_valatt(qkv, att, heads=None):
    """ref: ``_contrib_interleaved_matmul_selfatt_valatt`` — ``att v``
    back to (T, N, E)."""
    t, n, e3 = qkv.shape
    e = e3 // 3
    hd = e // heads
    v = qkv.reshape(t, n, heads, 3, hd)[:, :, :, 2]
    v = v.permute(1, 2, 0, 3).reshape(n * heads, t, hd)
    out = torch.matmul(att, v).reshape(n, heads, t, hd).permute(2, 0, 1, 3)
    return out.reshape(t, n, e)


def bilinear_resize_2d(x, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size", align_corners=True):
    """ref: ``BilinearResize2D`` (NCHW). With ``align_corners`` (and an
    output of more than one row and column) the corners map onto the
    corners, by the JAX op's four-tap gather; else half-pixel bilinear
    interpolation as ``jax.image.resize`` (antialiased when it shrinks)."""
    n, c, h, w = x.shape
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    if align_corners and height > 1 and width > 1:
        ys = torch.linspace(0.0, h - 1.0, height, device=x.device)
        xs = torch.linspace(0.0, w - 1.0, width, device=x.device)
        y0 = torch.floor(ys).long().clamp(0, h - 1)
        x0 = torch.floor(xs).long().clamp(0, w - 1)
        y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
        wy = (ys - y0).reshape(1, 1, -1, 1)
        wx = (xs - x0).reshape(1, 1, 1, -1)

        def g(yy, xx):
            return x[:, :, yy][:, :, :, xx]
        out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y1, x0) * wy * (1 - wx)
               + g(y0, x1) * (1 - wy) * wx + g(y1, x1) * wy * wx)
        return out.to(x.dtype)
    shrink = height < h or width < w
    return F.interpolate(x.float(), size=(height, width), mode="bilinear",
                         align_corners=False, antialias=shrink).to(x.dtype)


def adaptive_avg_pool_2d(x, output_size=None):
    """ref: ``AdaptiveAvgPooling2D`` — windows ``[floor(i h / oh), ceil((i
    + 1) h / oh))``, as the JAX op and ``F.adaptive_avg_pool2d``."""
    if not output_size:
        size = (1, 1)
    elif len(output_size) == 1:
        size = (int(output_size[0]),) * 2
    else:
        size = (int(output_size[0]), int(output_size[1]))
    return F.adaptive_avg_pool2d(x, size)


def count_sketch(data, h, s, out_dim=None, processing_batch_size=32):
    """ref: ``count_sketch`` — ``out[n, h[i]] += s[i] * data[n, i]``."""
    hh = h.reshape(-1).to(torch.int32).long()
    ss = s.reshape(-1).to(data.dtype)
    out = torch.zeros(data.shape[0], out_dim, dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, data * ss[None, :])


def fft(x, compute_size=128):
    """ref: ``_contrib_fft`` — FFT over the last axis, real and imaginary
    parts interleaved (..., 2d), float32."""
    spec = torch.fft.fft(x.float(), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(tuple(x.shape[:-1]) + (2 * x.shape[-1],)).float()


def ifft(x, compute_size=128):
    """ref: ``_contrib_ifft`` — the unnormalized inverse of :func:`fft`
    (``ifft(fft(x)) == d * x``), the real part."""
    d = x.shape[-1] // 2
    pairs = x.reshape(tuple(x.shape[:-1]) + (d, 2)).float()
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(spec, dim=-1).real * d).float()


def quadratic(x, a=0.0, b=0.0, c=0.0):
    """ref: ``_contrib_quadratic`` — ``a x^2 + b x + c``."""
    return a * x * x + b * x + c


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """ref: ``_contrib_allclose`` — one float32 scalar, 1 or 0."""
    close = torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                          equal_nan=equal_nan)
    return torch.all(close).float()


def index_copy(old, index, new):
    """ref: ``_contrib_index_copy`` — ``old`` with rows ``index`` replaced
    by ``new`` (a new array). An index outside the first axis raises, as
    the JAX op checks (one host read)."""
    idx = index.to(torch.int32).long()
    n = old.shape[0]
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n:
            raise MXNetError(f"index_copy: index out of range for dim-0 size "
                             f"{n} (got min {lo}, max {hi})")
    return old.index_copy(0, idx, new.to(old.dtype))


def boolean_mask(data, mask, axis=0):
    """ref: ``_contrib_boolean_mask`` — the slices of ``data`` along
    ``axis`` where the 1-D ``mask`` is non-zero (a data-dependent shape:
    one host read; eager only, as in the JAX package)."""
    if mask.ndim != 1:
        raise MXNetError(f"boolean_mask: mask must be 1-D, got shape "
                         f"{tuple(mask.shape)}")
    if mask.shape[0] != data.shape[axis]:
        raise MXNetError(f"boolean_mask: mask length {mask.shape[0]} != data "
                         f"axis {axis} size {data.shape[axis]}")
    keep = torch.nonzero(mask != 0).reshape(-1).to(data.device)
    return torch.index_select(data, axis, keep)


def _register_all():
    from .registry import OpParam, register

    def both(name, **kw):
        return register(f"_contrib_{name}", aliases=[name], **kw)

    register("_contrib_BilinearResize2D", aliases=["BilinearResize2D"],
             params=[OpParam("height", int, 0), OpParam("width", int, 0),
                     OpParam("scale_height", float, None),
                     OpParam("scale_width", float, None),
                     OpParam("mode", str, "size"),
                     OpParam("align_corners", bool, True)])(
        bilinear_resize_2d)
    register("_contrib_AdaptiveAvgPooling2D", aliases=["AdaptiveAvgPooling2D"],
             params=[OpParam("output_size", tuple, None)])(
        adaptive_avg_pool_2d)
    register("arange_like", differentiable=False,
             params=[OpParam("start", float, 0.0), OpParam("step", float, 1.0),
                     OpParam("repeat", int, 1), OpParam("axis", int, None)])(
        arange_like)
    both("div_sqrt_dim")(div_sqrt_dim)
    heads = [OpParam("heads", int, None, required=True)]
    register("_contrib_interleaved_matmul_selfatt_qk", params=heads)(
        interleaved_matmul_selfatt_qk)
    register("_contrib_interleaved_matmul_selfatt_valatt", num_inputs=2,
             params=heads)(interleaved_matmul_selfatt_valatt)
    register("_contrib_flash_attention", num_inputs=3,
             params=[OpParam("block_size", int, 512),
                     OpParam("causal", bool, False),
                     OpParam("sm_scale", float, None)],
             doc="Attention on [B, H, S, D]: the flash-attention kernel (K3) "
                 "above 1024 keys on a CUDA tensor")(flash_attention)
    register("_contrib_conv_epilogue", num_inputs=2,
             params=[OpParam("act_type", str, "relu")],
             doc="act(x + res): the conv-epilogue kernel (K1) on a CUDA "
                 "tensor")(conv_epilogue)
    register("_contrib_matmul_epilogue", num_inputs=2, needs_rng=True,
             needs_mode=True,
             params=[OpParam("act_type", str, None), OpParam("p", float, 0.0),
                     OpParam("layer", int, 0), OpParam("tick", int, 0)],
             doc="dropout(act(y + bias)): the matmul-epilogue kernel (K2) on "
                 "a CUDA tensor; ``layer`` and ``tick`` are accepted (the "
                 "bits come from the device's generator)")(
        lambda y, bias, generator=None, layer=0, tick=0, **p:
        matmul_epilogue(y, bias, generator=generator, **p))
    register("_contrib_fused_self_attention",
             params=heads + [OpParam("causal", bool, False),
                             OpParam("block_size", int, 512)])(
        fused_self_attention)
    both("count_sketch", num_inputs=3,
         params=[OpParam("out_dim", int, None, required=True),
                 OpParam("processing_batch_size", int, 32)])(count_sketch)
    size = [OpParam("compute_size", int, 128)]
    both("fft", params=size)(fft)
    both("ifft", params=size)(ifft)
    both("quadratic", params=[OpParam("a", float, 0.0),
                              OpParam("b", float, 0.0),
                              OpParam("c", float, 0.0)])(quadratic)
    both("allclose", num_inputs=2, differentiable=False,
         params=[OpParam("rtol", float, 1e-5), OpParam("atol", float, 1e-8),
                 OpParam("equal_nan", bool, False)])(allclose)
    both("index_copy", num_inputs=3)(index_copy)
    both("boolean_mask", num_inputs=2, differentiable=False,
         params=[OpParam("axis", int, 0)])(boolean_mask)


_register_all()
