"""The gradient of flash attention in the port (K3/K3''s backward:
mxnet_tpu_torch/kernels/flash_attention.py ``flash_attention_bwd_plain``
behind the ``autograd.Function`` of every entry) against the JAX package
on the CPU.

The JAX side is differentiated directly: ``jax.vjp`` of
``_blockwise_impl`` (K3', the ``lax.scan`` under ``jax.checkpoint``) and
of ``attention_reference``, ``jax.grad`` through ``_flash_attention``
(K3's op) and ``jax.vjp`` of ``_fused_self_attention``, never through the
Pallas tier's mode or environment. Inputs and the output cotangent are
seeded numpy arrays of shape (2, 3, S, D) unless a case says otherwise.
Tolerances, of each gradient's max |value|: float32 1e-4 (the port sums
the key blocks of dK/dV and dQ in another order than JAX's reverse scan;
the registered tolerance of K3' is 2e-4), bfloat16 2e-2 (bf16 inputs and
outputs on both sides, fp32 math inside). With one key (S_kv 1) dq and
dk are zero analytically (a softmax over one key is constant) and both
sides give the rounding noise of ``dp - delta``; there the scale is
floored at 0.1 (1e-5 absolute in fp32).

On bf16 and fp16 inputs the card's backward kernels compute the JAX
library's function: p and scale * ds are rounded to the input dtype
before the dv, dk and dq products (``flash_attention_bwd_plain`` with
``round_to``); this file holds that rounding against a dense computation
with explicit casts and, at the slice's D 64, against ``jax.vjp`` of
``_blockwise_impl`` in bf16.

The card's forward kernel, and its backward kernels on fp32 inputs,
compute every product in 3xTF32 on the tensor cores: x = hi + lo with
hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with ties
away from zero (cvt.rna.tf32.f32), and a b = a_lo b_hi + a_hi b_lo +
a_hi b_hi. No CPU here converts to TF32, so
this file emulates the rounding on fp32 bits (``_tf32_bits``) and the
product (``_mm_3xtf32``), holds the backward built from those products
against ``jax.vjp`` and the forward built from them (64-key tiles, as the
card streams them) against ``_blockwise_impl``, and pins the split down on
hand-picked values whose expected bits are written out."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.contrib import _flash_attention, _fused_self_attention
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.parallel import ring_attention as tra

jra = importlib.import_module("mxnet_tpu.parallel.ring_attention")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _arrays(seed, s_q, s_kv, lead=(2, 3), d=16):
    """q, k, v and the output cotangent, as float32 numpy."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*lead, s_q, d).astype(np.float32),
            rng.randn(*lead, s_kv, d).astype(np.float32),
            rng.randn(*lead, s_kv, d).astype(np.float32),
            rng.randn(*lead, s_q, d).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype, grad=True):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            .requires_grad_(grad) for a in arrays]


def _jax_vjp(fn, arrays, dtype):
    """(out, (dq, dk, dv)) of ``fn(q, k, v)`` with the cotangent of
    ``arrays[3]``."""
    q, k, v, do = _jax(arrays, dtype)
    out, pull = jax.vjp(fn, q, k, v)
    return out, pull(do)


def _port_grads(fn, arrays, dtype):
    q, k, v = _torch(arrays[:3], dtype)
    do = torch.from_numpy(arrays[3]).to(getattr(torch, dtype))
    out = fn(q, k, v)
    return out, torch.autograd.grad(out, (q, k, v), do)


def _check_grads(got, want, tol, floor=0.0):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


CASES = [(64, 64, 16), (200, 200, 16), (37, 200, 16), (200, 37, 16),
         (1, 200, 16), (200, 1, 16), (130, 130, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv,d", CASES)
def test_blockwise_grads_match_jax_vjp(s_q, s_kv, d, causal):
    """S_q = S_kv, S_q < S_kv and S_q > S_kv (causal: empty rows), S not
    a multiple of the block (48), D 16 and 64."""
    arrays = _arrays(s_q * 7 + s_kv + d, s_q, s_kv, d=d)
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, block_size=48, causal=causal), arrays, "float32")
    kernels.reset_launch_counts()
    _, got = _port_grads(lambda q, k, v: tra.blockwise_attention(
        q, k, v, block_size=48, causal=causal), arrays, "float32")
    _check_grads(got, want, TOL["float32"], floor=0.1 if s_kv == 1 else 0.0)
    assert not any(kernels.launch_counts().values())      # CPU path
    if causal and s_q > s_kv:           # rows with no allowed key: zeros
        assert not got[0][..., :s_q - s_kv, :].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(64, 64), (200, 37), (37, 200)])
def test_blockwise_grads_match_jax_vjp_bf16(s_q, s_kv, causal):
    arrays = _arrays(s_q + s_kv, s_q, s_kv)
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, block_size=32, causal=causal), arrays, "bfloat16")
    _, got = _port_grads(lambda q, k, v: tra.blockwise_attention(
        q, k, v, block_size=32, causal=causal), arrays, "bfloat16")
    assert all(g.dtype == torch.bfloat16 for g in got)
    _check_grads(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(7, 7), (64, 64), (37, 90),
                                      (90, 37)])
def test_attention_reference_grads_match_jax_vjp(s_q, s_kv, causal):
    """The dense oracle differentiates by plain autograd, as JAX
    differentiates it."""
    arrays = _arrays(s_q + 3 * s_kv, s_q, s_kv)
    _, want = _jax_vjp(lambda q, k, v: jra.attention_reference(
        q, k, v, causal=causal), arrays, "float32")
    _, got = _port_grads(lambda q, k, v: tra.attention_reference(
        q, k, v, causal=causal), arrays, "float32")
    _check_grads(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(1024, 1024), (1100, 1100),
                                      (64, 1100)])
def test_contrib_flash_attention_grads_match_jax_grad(s_q, s_kv, causal):
    """Both sides of the dense/streaming threshold (S_kv 1024 is dense,
    1100 streams) against ``jax.grad`` through ``_flash_attention``."""
    arrays = _arrays(s_kv + s_q, s_q, s_kv, lead=(1, 2))
    jq, jk, jv, jdo = _jax(arrays, "float32")
    want = jax.grad(lambda q, k, v: jnp.sum(
        _flash_attention(q, k, v, causal=causal) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    _, got = _port_grads(lambda q, k, v: tcontrib.flash_attention(
        q, k, v, causal=causal), arrays, "float32")
    _check_grads(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_vjp(causal):
    """``flash_attention_bwd_plain`` itself, fed the forward's lse."""
    arrays = _arrays(21, 90, 70)
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, block_size=16, causal=causal), arrays, "float32")
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    out, lse = fa.flash_attention_plain(q, k, v, block_size=16,
                                        causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 90)
    if causal:                          # 20 rows with no allowed key
        assert torch.isinf(lse[..., :20]).all()
        assert torch.isfinite(lse[..., 20:]).all()
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                       causal=causal, block_size=16)
    _check_grads(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
def test_three_d_entry_grads(causal):
    """``[B, S, D]`` inputs ride as one head through the same Function."""
    arrays = _arrays(31, 50, 90, lead=(3,))
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, block_size=32, causal=causal), arrays, "float32")
    out, got = _port_grads(lambda q, k, v: fa.flash_attention(
        q, k, v, block_size=32, causal=causal), arrays, "float32")
    assert out.shape == (3, 50, 16)
    _check_grads(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
def test_bshd_entry_grads_through_strided_views(causal):
    """(B, S, H, D) views of one fused tensor: the gradient reaches the
    fused tensor as the JAX gradient on the transposed copies."""
    rng = np.random.RandomState(9)
    qkv = rng.randn(2, 70, 3 * 24).astype(np.float32)
    do = rng.randn(2, 70, 3, 8).astype(np.float32)
    split = [qkv[:, :, i * 24:(i + 1) * 24].reshape(2, 70, 3, 8)
             .transpose(0, 2, 1, 3) for i in range(3)]
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, block_size=16, causal=causal),
        split + [do.transpose(0, 2, 1, 3)], "float32")
    tqkv = torch.from_numpy(qkv).requires_grad_()
    q, k, v = (tqkv[:, :, i * 24:(i + 1) * 24].reshape(2, 70, 3, 8)
               for i in range(3))
    out = fa.flash_attention_bshd(q, k, v, block_size=16, causal=causal)
    assert out.shape == (2, 70, 3, 8) and out.is_contiguous()
    (g,) = torch.autograd.grad(out, tqkv, torch.from_numpy(do))
    got = [g[:, :, i * 24:(i + 1) * 24].reshape(2, 70, 3, 8)
           .transpose(1, 2) for i in range(3)]
    _check_grads(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1100, 64])
def test_fused_self_attention_grad_into_fused_qkv(s, causal):
    """The gradient of ``fused_self_attention`` reaches the fused (B, S,
    3C) QKV as JAX's ``_fused_self_attention`` gives it: S 1100 takes the
    flash path's Function (one (B, S, 3C) gradient written through the
    column-block strides), S 64 the dense path's plain autograd."""
    rng = np.random.RandomState(s)
    qkv = rng.randn(2, s, 3 * 32).astype(np.float32)
    do = rng.randn(2, s, 32).astype(np.float32)
    _, pull = jax.vjp(lambda x: _fused_self_attention(
        x, heads=4, causal=causal), jnp.asarray(qkv))
    (want,) = pull(jnp.asarray(do))
    tqkv = torch.from_numpy(qkv).requires_grad_()
    out = tcontrib.fused_self_attention(tqkv, heads=4, causal=causal)
    assert out.shape == (2, s, 32)
    (got,) = torch.autograd.grad(out, tqkv, torch.from_numpy(do))
    assert got.shape == tqkv.shape and got.is_contiguous()
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL["float32"] * float(np.abs(want).max())


def test_no_grad_wanted_saves_nothing():
    """Inference through the Function keeps no lse and no graph."""
    q, k, v = _torch(_arrays(2, 20, 20)[:3], "float32", grad=False)
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, block_size=8)
    assert out.grad_fn is None
    q.requires_grad_()
    out = fa.flash_attention(q, k, v, block_size=8)
    assert out.grad_fn is not None


# -- the rounding of the 16-bit kernels: flash_attention_bwd_plain(round_to=)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(64, 64), (90, 70), (70, 90)])
def test_round_to_none_leaves_the_plain_backward_unchanged(s_q, s_kv,
                                                           causal):
    """``round_to=None`` is the plain backward as it was, bit for bit."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in _arrays(s_q + 2 * s_kv, s_q, s_kv))
    out, lse = fa.flash_attention_plain(q, k, v, block_size=16,
                                        causal=causal, return_lse=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                        causal=causal, block_size=16)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                       causal=causal, block_size=16,
                                       round_to=None)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _dense_rounded_bwd(q, k, v, out, lse, do, causal, scale, dtype):
    """The backward written densely in fp32 with the casts explicit: p and
    scale * ds rounded to ``dtype`` before the dv, dk and dq products."""
    s_q, s_kv = q.shape[-2], k.shape[-2]
    s = q @ k.transpose(-1, -2) * scale
    if causal:                          # bottom-right: j <= i + S_kv - S_q
        allowed = (torch.arange(s_kv)[None, :]
                   <= torch.arange(s_q)[:, None] + s_kv - s_q)
        s = torch.where(allowed, s, -1e30)
    p = torch.exp(s - lse[..., None])
    delta = (do * out).sum(-1)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    p_r = p.to(dtype).float()
    ds_r = (ds * scale).to(dtype).float()
    return ds_r @ k, ds_r.transpose(-1, -2) @ q, p_r.transpose(-1, -2) @ do


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(64, 64), (90, 37), (37, 90)])
def test_round_to_matches_dense_with_explicit_casts(s_q, s_kv, causal,
                                                    dtype):
    """With ``round_to`` the blockwise plain backward (16-key blocks)
    equals the dense one with explicit casts within 1e-6 of max |grad|.
    Inputs are quarter-integers in [-1, 1] held in fp32: exact in 16
    bits, and every score and dout . v is exact in fp32 whatever the
    order of its sum, so only the fp32 sums of the gradient products
    differ; the outputs stay fp32, so no final rounding hides an error."""
    rng = np.random.RandomState(s_q + s_kv + causal)
    q, k, v, do = (torch.from_numpy(
        rng.randint(-4, 5, size=(2, 3, n, 16)).astype(np.float32) / 4)
        for n in (s_q, s_kv, s_kv, s_q))
    scale = 0.25
    out, lse = fa.flash_attention_plain(q, k, v, block_size=16,
                                        causal=causal, scale=scale,
                                        return_lse=True)
    out = out.to(getattr(torch, dtype)).float()  # a 16-bit forward's out
    rnd = getattr(torch, dtype)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                       causal=causal, scale=scale,
                                       block_size=16, round_to=rnd)
    want = _dense_rounded_bwd(q, k, v, out, lse, do, causal, scale, rnd)
    unrounded = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal, scale=scale,
                                             block_size=16)
    for g, w, u in zip(got, want, unrounded):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        top = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-6 * top
        assert (u - w).abs().max().item() > 1e-6 * top  # the casts matter
    if causal and s_q > s_kv:           # rows with no allowed key: zeros
        assert not got[0][..., :s_q - s_kv, :].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1024, 2048])
def test_round_to_bf16_matches_jax_vjp(s, causal):
    """The plain backward with p and ds rounded to bf16 (what the card's
    16-bit kernels compute) on bf16 inputs at the slice's D 64 lies within
    the bf16 tolerance (2e-2 of max |grad|) of ``jax.vjp`` of
    ``_blockwise_impl``, as the unrounded one does
    (``test_blockwise_grads_match_jax_vjp_bf16``)."""
    arrays = _arrays(s + causal, s, s, lead=(1, 2), d=64)
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, causal=causal), arrays, "bfloat16")
    q, k, v, do = _torch(arrays, "bfloat16", grad=False)
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                       causal=causal,
                                       round_to=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _check_grads(got, want, TOL["bfloat16"])


def _tf32_bits(x):
    """cvt.rna.tf32.f32 on the bits of fp32 ``x`` (finite values): half a
    unit of the 13 dropped mantissa bits added to the magnitude, then those
    bits cleared; returns the uint32 bits."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)


def _split_tf32(x):
    """(hi, lo) as fp32: hi = tf32(x), lo = tf32(x - hi)."""
    x = np.asarray(x, dtype=np.float32)
    hi = _tf32_bits(x).view(np.float32)
    return hi, _tf32_bits(x - hi).view(np.float32)


def _mm_3xtf32(a, b):
    """a @ b in 3xTF32 with fp32 sums: the lo terms summed on their own,
    then added to hi @ hi (as the kernels' s and dp)."""
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    return a_hi @ b_hi + (a_lo @ b_hi + a_hi @ b_lo)


def _bwd_3xtf32(q, k, v, out, lse, do, causal, scale):
    """The kernels' backward on numpy fp32 [..., S, D] inputs, every
    product emulated in 3xTF32: p from the forward's lse (masked pairs and
    empty rows give 0), delta = sum(dout * out) in fp32."""
    s_q, s_kv = q.shape[-2], k.shape[-2]
    allowed = np.ones((s_q, s_kv), dtype=bool)
    if causal:                          # bottom-right: j <= i + S_kv - S_q
        allowed = (np.arange(s_kv)[None, :]
                   <= np.arange(s_q)[:, None] + s_kv - s_q)
    with np.errstate(over="ignore", invalid="ignore"):
        s = _mm_3xtf32(q, np.swapaxes(k, -1, -2))
        p = np.where(allowed, np.exp(s * np.float32(scale) - lse[..., None]),
                     np.float32(0))
    dp = _mm_3xtf32(do, np.swapaxes(v, -1, -2))
    delta = np.sum(do * out, axis=-1, dtype=np.float32)
    ds = (p * (dp - delta[..., None])).astype(np.float32)
    dv = _mm_3xtf32(np.swapaxes(p, -1, -2), do)
    dk = _mm_3xtf32(np.swapaxes(ds, -1, -2), q) * np.float32(scale)
    dq = _mm_3xtf32(ds, k) * np.float32(scale)
    return dq, dk, dv


@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("s_q,s_kv,causal", [(1100, 1100, False),
                                             (1100, 300, True)])
def test_3xtf32_backward_matches_jax_vjp(s_q, s_kv, causal, d):
    """The backward with every product in emulated 3xTF32 (the card
    kernels' arithmetic) against ``jax.vjp`` of ``_blockwise_impl``: S_q =
    S_kv = 1100, and S_q > S_kv causal (rows with no allowed key), D 64
    and D 40 (not a multiple of 8); fp32 tolerance."""
    arrays = _arrays(s_q + 5 * s_kv + d, s_q, s_kv, lead=(1, 2), d=d)
    _, want = _jax_vjp(lambda q, k, v: jra._blockwise_impl(
        q, k, v, causal=causal), arrays, "float32")
    q, k, v, do = arrays
    out, lse = fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        return_lse=True)
    got = _bwd_3xtf32(q, k, v, out.numpy(), lse.numpy(), do, causal,
                      fa.default_scale(d, torch.float32))
    _check_grads([torch.from_numpy(np.ascontiguousarray(g)) for g in got],
                 want, TOL["float32"])
    if causal and s_q > s_kv:           # rows with no allowed key: zeros
        assert not got[0][..., :s_q - s_kv, :].any()


def _fwd_3xtf32(q, k, v, causal, scale, tile=64):
    """The forward kernel's arithmetic on numpy fp32 [..., S, D] inputs:
    per tile of ``tile`` keys, s = q k^T in 3xTF32, scaled and masked to
    -1e30, the online softmax update with exact exp, p v in 3xTF32 added to
    o * alpha; out = o / l, rows with no allowed key zeros."""
    s_q, s_kv = q.shape[-2], k.shape[-2]
    neg = np.float32(-1e30)
    m = np.full(q.shape[:-1], neg, dtype=np.float32)
    l = np.zeros(q.shape[:-1], dtype=np.float32)
    o = np.zeros(q.shape, dtype=np.float32)
    rows = np.arange(s_q)[:, None]
    for n0 in range(0, s_kv, tile):
        kt, vt = k[..., n0:n0 + tile, :], v[..., n0:n0 + tile, :]
        s = _mm_3xtf32(q, np.swapaxes(kt, -1, -2)) * np.float32(scale)
        if causal:                      # bottom-right: j <= i + S_kv - S_q
            keys = n0 + np.arange(kt.shape[-2])[None, :]
            s = np.where(keys <= rows + s_kv - s_q, s, neg)
        m_new = np.maximum(m, s.max(axis=-1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[..., None])
        l = l * alpha + p.sum(axis=-1, dtype=np.float32)
        o = o * alpha[..., None] + _mm_3xtf32(p, vt)
        m = m_new
    out = o / l[..., None]
    if causal and s_q > s_kv:
        out[..., :s_q - s_kv, :] = 0.0
    return out


@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("s_q,s_kv,causal", [(1100, 1100, False),
                                             (300, 1100, True),
                                             (1100, 300, True)])
def test_3xtf32_forward_matches_jax_blockwise(s_q, s_kv, causal, d):
    """The forward with both products in emulated 3xTF32 over 64-key tiles
    (the card kernel's arithmetic) against ``_blockwise_impl``: S_q = S_kv
    = 1100, S_q < S_kv and S_q > S_kv causal (rows with no allowed key), D
    64 and D 40 (not a multiple of 8); within 1e-5 of max |out|, the card
    kernel's tolerance against its plain version."""
    q, k, v, _ = _arrays(2 * s_q + s_kv + d, s_q, s_kv, lead=(1, 2), d=d)
    want = np.asarray(jra._blockwise_impl(*_jax((q, k, v), "float32"),
                                          causal=causal))
    got = _fwd_3xtf32(q, k, v, causal, fa.default_scale(d, torch.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


# (x, hi = tf32(x), lo = tf32(x - hi)) as fp32 bit patterns: 1; the tie
# 1 + 2^-11 of both signs (away from zero); 1 + 2^-11 - 2^-23, just below
# the tie, whose lo is itself a tie; bits on both sides of the half unit;
# a carry into the exponent (just below 2); -pi; the smallest normal plus
# one unit (lo a subnormal rounded to 0); 1e38; -1/3
SPLIT_CASES = [
    (0x3F800000, 0x3F800000, 0x00000000),
    (0x3F801000, 0x3F802000, 0xBA000000),
    (0xBF801000, 0xBF802000, 0x3A000000),
    (0x3F800FFF, 0x3F800000, 0x3A000000),
    (0x3FABCDEF, 0x3FABC000, 0x39DF0000),
    (0x3FFFFFFF, 0x40000000, 0xB4000000),
    (0xC0490FDB, 0xC0490000, 0xBA7DC000),
    (0x00800001, 0x00800000, 0x00000000),
    (0x7E967699, 0x7E968000, 0xF8968000),
    (0xBEAAAAAB, 0xBEAAA000, 0xB8AAC000),
]


@pytest.mark.parametrize("x_bits,hi_bits,lo_bits", SPLIT_CASES)
def test_tf32_split_bits(x_bits, hi_bits, lo_bits):
    """The split the kernels' comment describes: hi has its low 13
    mantissa bits zero and rounds to nearest with ties away from zero (as
    cvt.rna does); lo = tf32(x - hi) has its low 13 bits zero too; and
    |x - (hi + lo)| <= 2^-22 |x|."""
    x = np.array([x_bits], dtype=np.uint32).view(np.float32)
    hi, lo = _split_tf32(x)
    got_hi, got_lo = int(hi.view(np.uint32)[0]), int(lo.view(np.uint32)[0])
    assert (got_hi, got_lo) == (hi_bits, lo_bits), (hex(got_hi), hex(got_lo))
    assert got_hi & 0x1FFF == 0 and got_lo & 0x1FFF == 0
    x64 = float(x[0])
    err = abs(x64 - (float(hi[0]) + float(lo[0])))
    assert err <= 2.0 ** -22 * abs(x64)
    # round to nearest: hi is one of the two tf32 neighbours of x, the
    # nearer one, and at a tie the one farther from zero
    down = x_bits & 0xFFFFE000
    up = down + 0x2000
    assert got_hi in (down, up)
    dropped = x_bits & 0x1FFF
    assert got_hi == (up if dropped >= 0x1000 else down)

