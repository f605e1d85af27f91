"""K3/K3', flash attention: ``softmax(scale * q k^T, masked) v`` streamed
over key blocks with an online softmax, so no S_q x S_kv score tensor is
ever held.

Counterpart of two TPU entries that compute the same function:
``mxnet_tpu/ops/contrib.py`` ``_flash_attention`` (K3, the JAX library's
Pallas TPU kernel above 1024 keys) and ``mxnet_tpu/pallas/kernels.py``
``_blockwise_pallas`` (K3', the ``lax.scan`` online softmax of
``parallel/ring_attention.py`` ``_blockwise_impl`` that every other
backend runs). The port has one kernel for both. Causal masking is
bottom-right aligned (query i attends keys j <= i + S_kv - S_q); a query
row with no allowed key comes out as zeros. All math is fp32 and the
output has q's dtype.

- :func:`flash_attention_plain` is the plain PyTorch version, a mirror
  of ``_blockwise_impl``: the CPU path, and the yardstick the kernel is
  held against on the card.
- :func:`flash_attention` is the ``[..., S, D]`` entry (what
  ``parallel.ring_attention.blockwise_attention`` calls).
- :func:`flash_attention_bshd` takes (B, S, H, D) views with any batch,
  sequence and head strides and a contiguous D, and returns (B, S_q, H,
  D) contiguous: ``ops.contrib.fused_self_attention`` passes the column
  blocks of its fused QKV in place.

A CPU tensor goes to the plain version; a CUDA tensor goes to the
hand-written kernel in ``csrc/flash_attention.cu`` or the call raises
(there is no fallback, no gate on S or D below the kernel's limit of
D <= 256, and no silent copy to make an input fit).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from . import _build
from ._common import DTYPE_CODE, LaunchCount

__all__ = ["MAX_HEAD_DIM", "default_scale", "flash_attention",
           "flash_attention_bshd", "flash_attention_plain", "launch_count"]

MAX_HEAD_DIM = 256          # the kernel's largest compiled head dim
_NEG = -1e30                # the mask value of _blockwise_impl
launch_count = LaunchCount()


def default_scale(d, dtype):
    """``1 / sqrt(d)`` rounded as the JAX package rounds its default
    (``1.0 / jnp.sqrt(d).astype(q.dtype)``): in q's dtype."""
    root = torch.tensor(float(d), dtype=torch.float32).sqrt().to(dtype)
    return float(1.0 / root)


def flash_attention_plain(q, k, v, block_size=512, causal=False,
                          scale=None):
    """The plain version (``_blockwise_impl``): ``block_size`` shrinks to
    a divisor of S_kv; per block the scores of fp32 q and k, masked with
    -1e30 under ``causal``, update the running max m, sum l and output o
    in fp32 (``_online_block``); the result ``o / l`` is cast to q's
    dtype and the rows with an empty allowed set are zeroed. Inputs
    ``[..., S, D]``; memory O(S_q * block)."""
    d = q.shape[-1]
    s_q, s_k = q.shape[-2], k.shape[-2]
    scale = default_scale(d, q.dtype) if scale is None else scale
    block = min(block_size, s_k)
    while s_k % block:
        block -= 1
    qf = q.float()
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                    device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    q_pos = torch.arange(s_q, device=q.device)
    for start in range(0, s_k, block):
        k_blk = k[..., start:start + block, :].float()
        v_blk = v[..., start:start + block, :].float()
        scores = torch.einsum("...qd,...kd->...qk", qf, k_blk) * scale
        if causal:
            k_pos = start + torch.arange(block, device=q.device)
            mask = q_pos[:, None] + (s_k - s_q) >= k_pos[None, :]
            scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        o = o * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                                v_blk)
        m = m_new
    out = (o / l[..., None]).to(q.dtype)
    if causal and s_q > s_k:
        valid = q_pos + (s_k - s_q) >= 0
        out = out * valid[:, None].to(out.dtype)
    return out


@functools.cache
def _lib():
    """The built kernel library, its C signature declared."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_int] + [ctypes.c_longlong] * 12 \
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_bshd(q, k, v):
    """Raise on anything the kernel does not take: (B, S, H, D) views on
    the current CUDA device, one supported dtype, k and v of one shape
    with q's B, H and D, D at most MAX_HEAD_DIM and contiguous."""
    what = "flash attention kernel"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise MXNetError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise MXNetError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise MXNetError(f"{what}: {name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise MXNetError(f"{what}: {name}'s head dim is not contiguous "
                             f"(strides {t.stride()})")
    if q.dtype not in DTYPE_CODE:
        raise MXNetError(f"{what}: dtype {q.dtype} not supported; one of "
                         f"{list(DTYPE_CODE)}")
    if q.device.index != torch.cuda.current_device():
        raise MXNetError(f"{what}: input on {q.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h,
                                                                       d):
        raise MXNetError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} do not match as (B, S, H, "
                         "D) with one B, H and D")
    if d > MAX_HEAD_DIM:
        raise MXNetError(f"{what}: head dim {d} > {MAX_HEAD_DIM}, the "
                         "kernel's limit")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise MXNetError(f"{what}: an input requires grad; the kernel has "
                         "no backward yet (run under torch.inference_mode() "
                         "or torch.no_grad())")


def _launch(q, k, v, out, causal, scale):
    """Launch the kernel on (B, S, H, D) views ``q``, ``k``, ``v`` into
    the (B, S_q, H, D) view ``out`` (checked by the caller)."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if out.numel() == 0:
        return
    if s_kv == 0:
        raise MXNetError("flash attention kernel: no keys (S_kv = 0)")
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [x for t in (q, k, v, out)
               for x in (t.stride(0), t.stride(1), t.stride(2))]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, s_q, s_kv, d, *strides, int(bool(causal)), float(scale),
        DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash attention kernel launch failed: "
                         + lib.flash_attention_error_string(err).decode())
    launch_count.add()


def _device_kind(q, k, v):
    kinds = {t.device.type for t in (q, k, v)}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise MXNetError(f"flash attention: inputs on {q.device}, {k.device} "
                     f"and {v.device}; all must be on the CPU or all on "
                     "one CUDA device")


def flash_attention_bshd(q, k, v, block_size=512, causal=False,
                         scale=None):
    """(B, S, H, D) entry: ``q`` (B, S_q, H, D), ``k`` and ``v`` (B,
    S_kv, H, D), each with any batch, sequence and head strides and a
    contiguous D; returns (B, S_q, H, D) contiguous. ``block_size`` is
    the plain version's key block; the kernel ignores it (a perf knob,
    not a correctness contract)."""
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    if _device_kind(q, k, v) == "cpu":
        out = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), block_size=block_size,
                                    causal=causal, scale=scale)
        return out.transpose(1, 2).contiguous()
    _check_bshd(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, scale)
    return out


def _as_bshd(x, name):
    """An ``[..., S, D]`` tensor as a (B, S, H, D) view, without a copy:
    (S, D) and (N, S, D) ride as H = 1, (B, H, S, D) is transposed in
    place, more leading axes are merged into B where their strides
    allow it."""
    if x.ndim < 2:
        raise MXNetError(f"flash attention: {name} must be [..., S, D], "
                         f"got {tuple(x.shape)}")
    if x.ndim == 2:
        return x[None, :, None, :]
    if x.ndim == 3:
        return x[:, :, None, :]
    if x.ndim > 4:
        try:
            x = x.view(-1, *x.shape[-3:])
        except RuntimeError:
            raise MXNetError(f"flash attention: the leading axes of {name} "
                             f"{tuple(x.shape)} (strides {x.stride()}) do "
                             "not merge into one without a copy") from None
    return x.transpose(1, 2)


def flash_attention(q, k, v, block_size=512, causal=False, scale=None):
    """``[..., S, D]`` entry: ``q`` [..., S_q, D], ``k`` and ``v`` [...,
    S_kv, D] with the same leading axes; returns [..., S_q, D] in q's
    dtype. A CPU tensor runs the plain version, a CUDA tensor the
    kernel."""
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    if _device_kind(q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, block_size=block_size,
                                     causal=causal, scale=scale)
    if q.shape[:-2] != k.shape[:-2] or k.shape != v.shape:
        raise MXNetError(f"flash attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must "
                         "share their leading axes, k and v their shape")
    q4, k4, v4 = (_as_bshd(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    _check_bshd(q4, k4, v4)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q4, k4, v4, _as_bshd(out, "out"), causal, scale)
    return out
