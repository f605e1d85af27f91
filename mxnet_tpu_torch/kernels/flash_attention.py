"""K3/K3', flash attention: ``softmax(scale * q k^T, masked) v`` streamed
over key blocks with an online softmax, so no S_q x S_kv score tensor is
ever held, and its gradient.

Counterpart of two TPU entries that compute the same function:
``mxnet_tpu/ops/contrib.py`` ``_flash_attention`` (K3, the JAX library's
Pallas TPU kernel above 1024 keys, whose VJP runs two more Pallas kernels,
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``) and
``mxnet_tpu/pallas/kernels.py`` ``_blockwise_pallas`` (K3', the
``lax.scan`` online softmax of ``parallel/ring_attention.py``
``_blockwise_impl`` that every other backend runs, differentiated by JAX
under ``jax.checkpoint``). The port has one forward kernel and one pair of
backward kernels for both. Causal masking is bottom-right aligned (query i
attends keys j <= i + S_kv - S_q); a query row with no allowed key comes
out as zeros and gets zero gradients. All math is fp32 and the outputs
have q's dtype, with one exception: on bf16 and fp16 inputs the kernels
compute the library's 16-bit function. The forward rounds p to v's dtype
before p v, against the running max of each 128-key block, with l from
the unrounded p (``flash_attention_plain(..., round_to=dtype,
block_size=128)``); the backward rounds p and scale * ds to the input
dtype before the gradient products (``flash_attention_bwd_plain(...,
round_to=dtype)``), as the library's kernels do on bf16 inputs.

- :func:`flash_attention_plain` is the plain PyTorch version of the
  forward, a mirror of ``_blockwise_impl``, and
  :func:`flash_attention_bwd_plain` that of the backward: the CPU path,
  and the yardsticks the kernels are held against on the card.
- :func:`flash_attention` is the ``[..., S, D]`` entry (what
  ``parallel.ring_attention.blockwise_attention`` calls).
- :func:`flash_attention_bshd` takes (B, S, H, D) views with any batch,
  sequence and head strides and a contiguous D, and returns (B, S_q, H,
  D) contiguous.
- :func:`flash_attention_qkv` takes the fused QKV projection (B, S, 3C)
  of ``ops.contrib.fused_self_attention``, reads its three column blocks
  in place and writes its gradient as one (B, S, 3C) tensor through the
  same strides.

Each entry is a ``torch.autograd.Function``: the forward saves the row
log-sum-exp ``lse`` (fp32, +inf for a row with no allowed key) when an
input requires grad; the backward recomputes the probabilities from it.
A CPU tensor goes to the plain versions; a CUDA tensor goes to the
hand-written kernels in ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (dK/dV and dQ) or the call raises (there
is no fallback, no gate on S or D below the kernels' limit of D <= 256,
and no silent copy to make an input fit).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from . import _build
from ._common import DTYPE_CODE, LaunchCount, note_route

__all__ = ["MAX_HEAD_DIM", "bwd_dkv_launch_count", "bwd_dq_launch_count",
           "default_scale", "flash_attention", "flash_attention_bshd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "flash_attention_qkv", "launch_count"]

MAX_HEAD_DIM = 256          # the kernels' largest compiled head dim
_NEG = -1e30                # the mask value of _blockwise_impl
launch_count = LaunchCount()
bwd_dkv_launch_count = LaunchCount()
bwd_dq_launch_count = LaunchCount()


def default_scale(d, dtype):
    """``1 / sqrt(d)`` rounded as the JAX package rounds its default
    (``1.0 / jnp.sqrt(d).astype(q.dtype)``): in q's dtype."""
    root = torch.tensor(float(d), dtype=torch.float32).sqrt().to(dtype)
    return float(1.0 / root)


def _block(block_size, s_k):
    """The largest key block up to ``block_size`` that divides S_kv."""
    block = min(block_size, s_k)
    while s_k % block:
        block -= 1
    return block


def _causal_mask(s_q, s_k, start, block, device):
    """Allowed (query, key) pairs of keys [start, start + block):
    bottom-right aligned, key j <= i + S_kv - S_q."""
    q_pos = torch.arange(s_q, device=device)
    k_pos = start + torch.arange(block, device=device)
    return q_pos[:, None] + (s_k - s_q) >= k_pos[None, :]


def flash_attention_plain(q, k, v, block_size=512, causal=False,
                          scale=None, return_lse=False, round_to=None):
    """The plain version (``_blockwise_impl``): ``block_size`` shrinks to
    a divisor of S_kv; per block the scores of fp32 q and k, masked with
    -1e30 under ``causal``, update the running max m, sum l and output o
    in fp32 (``_online_block``); the result ``o / l`` is cast to q's
    dtype and the rows with an empty allowed set are zeroed. Inputs
    ``[..., S, D]``; memory O(S_q * block). With ``return_lse`` it also
    returns the fp32 row log-sum-exp ``m + log l`` ([..., S_q], +inf for
    an empty row), what the backward recomputes the probabilities from.

    With ``round_to`` (a 16-bit dtype) each block's p is rounded to it
    before the p v product, as the JAX library's Pallas forward rounds it
    on bf16 inputs (``p.astype(v.dtype)``, against the running max of
    each 128-key block: pass ``block_size=128``); l sums the unrounded p.
    That is the function the card's 16-bit kernels compute. The CPU path,
    a mirror of ``_blockwise_impl``, passes none."""
    d = q.shape[-1]
    s_q, s_k = q.shape[-2], k.shape[-2]
    scale = default_scale(d, q.dtype) if scale is None else scale
    block = _block(block_size, s_k)
    qf = q.float()
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                    device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    for start in range(0, s_k, block):
        k_blk = k[..., start:start + block, :].float()
        v_blk = v[..., start:start + block, :].float()
        scores = torch.einsum("...qd,...kd->...qk", qf, k_blk) * scale
        if causal:
            scores = torch.where(
                _causal_mask(s_q, s_k, start, block, q.device), scores, _NEG)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        if round_to is not None:
            p = p.to(round_to).float()
        o = o * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                                v_blk)
        m = m_new
    out = (o / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    if causal and s_q > s_k:
        valid = torch.arange(s_q, device=q.device) + (s_k - s_q) >= 0
        out = out * valid[:, None].to(out.dtype)
        lse = torch.where(valid, lse, torch.inf)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False,
                              scale=None, block_size=512, round_to=None):
    """The plain version of the backward, on ``[..., S, D]`` inputs with
    ``lse`` [..., S_q] from the forward: per key block of ``block_size``
    (shrunk to a divisor of S_kv), in fp32, ``p = exp(scale q k^T - lse)``
    with the scores masked to -1e30 under ``causal``, ``dv = p^T dout``,
    ``dp = dout v^T``, ``ds = p * (dp - delta)`` with ``delta = sum(dout
    * out)`` per row, ``dq += scale ds k``, ``dk = scale ds^T q``. No S_q x
    S_kv tensor is held; rows with an empty allowed set (lse +inf) get
    zero gradients. Returns (dq, dk, dv) in the inputs' dtypes.

    With ``round_to`` (a 16-bit dtype) p and ``scale * ds`` are rounded
    to it before the dv, dk and dq products, as the JAX library's Pallas
    backward rounds them on bf16 inputs (``p.T.astype(do.dtype)``,
    ``ds.T.astype(do.dtype)`` after the scale, ``ds.astype(k.dtype)``):
    the function the card's 16-bit kernels compute. The CPU path, a
    mirror of ``_blockwise_impl`` differentiated in fp32 math, passes
    none."""
    d = q.shape[-1]
    s_q, s_k = q.shape[-2], k.shape[-2]
    scale = default_scale(d, q.dtype) if scale is None else scale
    block = _block(block_size, s_k)
    qf, dof = q.float(), dout.float()
    delta = torch.sum(dof * out.float(), dim=-1)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, s_k, block):
        k_blk = k[..., start:start + block, :].float()
        v_blk = v[..., start:start + block, :].float()
        scores = torch.einsum("...qd,...kd->...qk", qf, k_blk) * scale
        if causal:
            scores = torch.where(
                _causal_mask(s_q, s_k, start, block, q.device), scores, _NEG)
        p = torch.exp(scores - lse[..., None])
        dp = torch.einsum("...qd,...kd->...qk", dof, v_blk)
        ds = p * (dp - delta[..., None])
        if round_to is not None:
            p = p.to(round_to).float()
            ds = (ds * scale).to(round_to).float()
            dq = dq + torch.einsum("...qk,...kd->...qd", ds, k_blk)
            dks.append(torch.einsum("...qk,...qd->...kd", ds, qf))
        else:
            dq = dq + torch.einsum("...qk,...kd->...qd", ds, k_blk) * scale
            dks.append(torch.einsum("...qk,...qd->...kd", ds, qf) * scale)
        dvs.append(torch.einsum("...qk,...qd->...kd", p, dof))
    return (dq.to(q.dtype), torch.cat(dks, dim=-2).to(k.dtype),
            torch.cat(dvs, dim=-2).to(v.dtype))


@functools.cache
def _lib():
    """The built forward library, its C signature declared."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_int] + [ctypes.c_longlong] * 12 \
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    """The built backward library, its C signatures declared."""
    lib = _build.load("flash_attention_bwd")
    shape = [ctypes.c_longlong] * 4 + [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_bwd_dkv_launch.argtypes = \
        [ctypes.c_void_p] * 8 + shape
    lib.flash_attention_bwd_dq_launch.argtypes = \
        [ctypes.c_void_p] * 7 + shape
    for fn in (lib.flash_attention_bwd_dkv_launch,
               lib.flash_attention_bwd_dq_launch):
        fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bshd(q, k, v):
    """Raise on anything the kernels do not take: (B, S, H, D) views on
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


def _strides(*tensors):
    return [x for t in tensors for x in (t.stride(0), t.stride(1),
                                         t.stride(2))]


def _launch(q, k, v, out, lse, causal, scale):
    """Launch the forward kernel on (B, S, H, D) views ``q``, ``k``,
    ``v`` into the (B, S_q, H, D) view ``out`` (checked by the caller),
    and into ``lse`` (a contiguous fp32 (B, H, S_q)) unless it is None."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if out.numel() == 0:
        return
    if s_kv == 0:
        raise MXNetError("flash attention kernel: no keys (S_kv = 0)")
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, s_q, s_kv, d,
        *_strides(q, k, v, out), int(bool(causal)), float(scale),
        DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise MXNetError("flash attention kernel launch failed: "
                         + lib.flash_attention_error_string(err).decode())
    launch_count.add()


def _bwd_delta(out, dout):
    """``delta = sum(dout * out)`` per row as a contiguous fp32 (B, H,
    S_q), from (B, S_q, H, D) views: one PyTorch reduction, as the JAX
    library computes it in plain JAX between its two backward kernels."""
    return torch.sum(dout.float() * out.float(), dim=-1).transpose(
        1, 2).contiguous()


def _launch_bwd_kernel(which, q, k, v, dout, lse, delta, grads, causal,
                       scale):
    """Launch one backward kernel on (B, S, H, D) views: ``which`` "dkv"
    writes ``grads`` = (dk, dv), "dq" writes ``grads`` = (dq,)."""
    b, s_q, h, d = q.shape
    lib = _bwd_lib()
    fn, count = {"dkv": (lib.flash_attention_bwd_dkv_launch,
                         bwd_dkv_launch_count),
                 "dq": (lib.flash_attention_bwd_dq_launch,
                        bwd_dq_launch_count)}[which]
    dq, dk, dv = (grads[0], None, None) if which == "dq" \
        else (None, *grads)
    strides = (ctypes.c_longlong * 21)(*(
        x for t in (q, k, v, dout, dq, dk, dv)
        for x in ((0, 0, 0) if t is None else _strides(t))))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             *(g.data_ptr() for g in grads), lse.data_ptr(),
             delta.data_ptr(), b, h, s_q, k.shape[1], d, strides,
             int(bool(causal)), float(scale), DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError("flash attention backward kernel launch failed: "
                         + lib.flash_attention_bwd_error_string(err)
                         .decode())
    count.add()


def _launch_bwd(q, k, v, out, lse, dout, dq, dk, dv, causal, scale):
    """The backward on (B, S, H, D) views: dK and dV into ``dk``, ``dv``,
    then dQ into ``dq``."""
    if q.numel() == 0 or k.numel() == 0:
        for g in (dq, dk, dv):
            g.zero_()
        return
    if dout.dtype != q.dtype or dout.device != q.device \
            or tuple(dout.shape) != tuple(q.shape) \
            or (q.shape[-1] > 1 and dout.stride(-1) != 1):
        raise MXNetError(f"flash attention backward: dout {dout.dtype} "
                         f"{tuple(dout.shape)} (strides {dout.stride()}) "
                         f"on {dout.device} does not match q {q.dtype} "
                         f"{tuple(q.shape)} on {q.device} with a "
                         "contiguous D")
    delta = _bwd_delta(out, dout)
    _launch_bwd_kernel("dkv", q, k, v, dout, lse, delta, (dk, dv), causal,
                       scale)
    _launch_bwd_kernel("dq", q, k, v, dout, lse, delta, (dq,), causal,
                       scale)


def _device_kind(q, k, v):
    kinds = {t.device.type for t in (q, k, v)}
    # a meta tensor computes nothing: it takes the plain versions, whose
    # shapes it needs (shape inference)
    if kinds in ({"cpu"}, {"meta"}):
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise MXNetError(f"flash attention: inputs on {q.device}, {k.device} "
                     f"and {v.device}; all must be on the CPU or all on "
                     "one CUDA device")


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


def _layout(tensors, names, bshd):
    """The tensors as (B, S, H, D) views: as they are when ``bshd``, else
    through :func:`_as_bshd` from ``[..., S, D]``."""
    if bshd:
        return list(tensors)
    return [_as_bshd(t, n) for t, n in zip(tensors, names)]


def _plain_layout(t, bshd):
    """A tensor of the entry's layout in the plain versions' [..., S, D]
    one (and back: the transpose is its own inverse)."""
    return t.transpose(1, 2) if bshd else t


def _attend(q, k, v, causal, scale, block_size, want_lse, bshd):
    """The forward on q, k, v as (B, S, H, D) views (``bshd``) or
    ``[..., S, D]``. Returns (out in q's layout, contiguous; lse or None):
    lse is (B, H, S_q) for the kernel, [..., S_q] of the plain version's
    layout on the CPU."""
    note_route("flash_attention", q.device)
    if _device_kind(q, k, v) == "cpu":
        out, lse = flash_attention_plain(
            *(_plain_layout(t, bshd) for t in (q, k, v)),
            block_size=block_size, causal=causal, scale=scale,
            return_lse=True)
        return _plain_layout(out, bshd).contiguous(), \
            (lse if want_lse else None)
    views = _layout((q, k, v), ("q", "k", "v"), bshd)
    _check_bshd(*views)
    b, s_q, h, _ = views[0].shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s_q, dtype=torch.float32, device=q.device) \
        if want_lse else None
    _launch(*views, *_layout((out,), ("out",), bshd), lse, causal, scale)
    return out, lse


def _attend_bwd(q, k, v, out, lse, dout, grads, causal, scale, block_size,
                bshd):
    """The backward into ``grads`` = (dq, dk, dv): tensors of q's, k's and
    v's shapes, or views of one fused gradient, in the layout of
    :func:`_attend`."""
    note_route("flash_attention_bwd", q.device)
    if _device_kind(q, k, v) == "cpu":
        got = flash_attention_bwd_plain(
            *(_plain_layout(t, bshd) for t in (q, k, v, out)), lse,
            _plain_layout(dout, bshd), causal=causal, scale=scale,
            block_size=block_size)
        for g, x in zip(grads, got):
            g.copy_(_plain_layout(x, bshd))
        return
    names = ("q", "k", "v", "out", "dout", "dq", "dk", "dv")
    q, k, v, out, dout, *grads = _layout((q, k, v, out, dout, *grads),
                                         names, bshd)
    _launch_bwd(q, k, v, out, lse, dout, *grads, causal, scale)


class _Attention(torch.autograd.Function):
    """Flash attention on q, k, v of one layout (:func:`_attend`): the
    kernels, or the plain versions on the CPU, both ways."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_size, bshd):
        want = any(ctx.needs_input_grad[:3])
        out, lse = _attend(q, k, v, causal, scale, block_size, want, bshd)
        if want:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (causal, scale, block_size, bshd)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_size, bshd = ctx.args
        grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v)]
        _attend_bwd(q, k, v, out, lse, dout.contiguous(), grads, causal,
                    scale, block_size, bshd)
        return (*grads, None, None, None, None)


class _FusedQKVAttention(torch.autograd.Function):
    """Self-attention off a fused (B, S, 3C) QKV: the forward reads its
    three column blocks in place, the backward writes dQ, dK and dV into
    one (B, S, 3C) gradient through the same strides."""

    @staticmethod
    def forward(ctx, qkv, heads, causal, scale, block_size):
        want = ctx.needs_input_grad[0]
        out, lse = _attend(*_split_qkv(qkv, heads), causal, scale,
                           block_size, want, True)
        if want:
            ctx.save_for_backward(qkv, out, lse)
            ctx.args = (heads, causal, scale, block_size)
        b, s, c3 = qkv.shape
        return out.view(b, s, c3 // 3)

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        heads, causal, scale, block_size = ctx.args
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        _attend_bwd(*_split_qkv(qkv, heads), out, lse,
                    dout.contiguous().view(out.shape),
                    _split_qkv(dqkv, heads), causal, scale, block_size,
                    True)
        return dqkv, None, None, None, None


def _split_qkv(qkv, heads):
    """The q, k and v column blocks of a (B, S, 3C) tensor as strided
    (B, S, H, D) views."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    return tuple(qkv[:, :, i * c:(i + 1) * c].view(b, s, heads, c // heads)
                 for i in range(3))


def flash_attention_bshd(q, k, v, block_size=512, causal=False,
                         scale=None):
    """(B, S, H, D) entry: ``q`` (B, S_q, H, D), ``k`` and ``v`` (B,
    S_kv, H, D), each with any batch, sequence and head strides and a
    contiguous D; returns (B, S_q, H, D) contiguous. ``block_size`` is
    the plain version's key block; the kernels ignore it (a perf knob,
    not a correctness contract). Differentiable."""
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    return _Attention.apply(q, k, v, causal, scale, block_size, True)


def flash_attention_qkv(qkv, heads, block_size=512, causal=False,
                        scale=None):
    """Self-attention off the fused QKV projection ``qkv`` (B, S, 3C),
    q-major column blocks, ``heads`` heads; returns (B, S, C).
    Differentiable: its gradient is one (B, S, 3C) tensor, written by the
    backward kernels through the forward's column-block strides (no
    concatenation, no transposes)."""
    c = qkv.shape[-1] // 3
    scale = default_scale(c // heads, qkv.dtype) if scale is None else scale
    return _FusedQKVAttention.apply(qkv, heads, causal, scale, block_size)


def flash_attention(q, k, v, block_size=512, causal=False, scale=None):
    """``[..., S, D]`` entry: ``q`` [..., S_q, D], ``k`` and ``v`` [...,
    S_kv, D] with the same leading axes; returns [..., S_q, D] in q's
    dtype. A CPU tensor runs the plain versions, a CUDA tensor the
    kernels. Differentiable."""
    scale = default_scale(q.shape[-1], q.dtype) if scale is None else scale
    if _device_kind(q, k, v) == "cuda" and (
            q.shape[:-2] != k.shape[:-2] or k.shape != v.shape):
        raise MXNetError(f"flash attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must "
                         "share their leading axes, k and v their shape")
    return _Attention.apply(q, k, v, causal, scale, block_size, False)
