"""The 16-bit function of K3's forward on the card, held on the CPU.

On bf16 and fp16 inputs the card's forward kernel computes the JAX
library's Pallas TPU forward (``jax/experimental/pallas/ops/tpu/
flash_attention.py``, ``_flash_attention_kernel``): per 128-key block the
running max m, p = exp(s - m) in fp32, l summed from the unrounded p and
``p.astype(v.dtype)`` before the p v product. The port's plain version
of that function is ``flash_attention_plain(..., round_to=dtype,
block_size=128)``. This file holds it against the library's kernel run
under ``pltpu.force_tpu_interpret_mode()`` (its default 128-key blocks)
at B 1, H 2, S 512, D 64, and checks that ``round_to=None`` leaves the
plain version as it was, bit for bit.

Tolerances, of max |out|: 3e-3 (bf16) and 1e-3 (fp16), against
1.0e-3 and 2.6e-4 measured on these inputs; the two sides sum in another
order and the library normalises its accumulator every block, so a p on
the edge of a rounding step may round the other way. In every case the
unrounded plain version (p in fp32) must lie strictly further from the
library than the rounded one: a check that cannot tell the two functions
apart guards nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as tpu_fa

from mxnet_tpu_torch.kernels import flash_attention as fa

TOL = {"bfloat16": 3e-3, "float16": 1e-3}
SCALE = 0.125                       # 1 / sqrt(64)


def _arrays(seed, s_q, s_kv, lead=(1, 2), d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(*lead, s_q, d).astype(np.float32),
            rng.randn(*lead, s_kv, d).astype(np.float32),
            rng.randn(*lead, s_kv, d).astype(np.float32))


def _plain_as_before(q, k, v, block_size, causal, scale):
    """``flash_attention_plain`` as it was before ``round_to``: the
    blockwise online softmax of ``_blockwise_impl`` in fp32, with lse."""
    s_q, s_k = q.shape[-2], k.shape[-2]
    block = fa._block(block_size, s_k)
    qf = q.float()
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32)
    m = torch.full(q.shape[:-1], -1e30, dtype=torch.float32)
    for start in range(0, s_k, block):
        k_blk = k[..., start:start + block, :].float()
        v_blk = v[..., start:start + block, :].float()
        scores = torch.einsum("...qd,...kd->...qk", qf, k_blk) * scale
        if causal:
            scores = torch.where(
                fa._causal_mask(s_q, s_k, start, block, q.device), scores,
                -1e30)
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        o = o * alpha[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                                v_blk)
        m = m_new
    out = (o / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    if causal and s_q > s_k:
        valid = torch.arange(s_q) + (s_k - s_q) >= 0
        out = out * valid[:, None].to(out.dtype)
        lse = torch.where(valid, lse, torch.inf)
    return out, lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv,block", [(64, 64, 16), (90, 37, 16),
                                            (37, 90, 128)])
def test_round_to_none_is_the_plain_forward_bit_for_bit(s_q, s_kv, block,
                                                        causal, dtype):
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _arrays(s_q + s_kv, s_q, s_kv, lead=(2, 3), d=16))
    want_out, want_lse = _plain_as_before(q, k, v, block, causal, 0.25)
    got_out, got_lse = fa.flash_attention_plain(
        q, k, v, block_size=block, causal=causal, scale=0.25,
        return_lse=True, round_to=None)
    assert torch.equal(got_out, want_out)
    assert torch.equal(got_lse, want_lse)


def test_round_to_keeps_l_from_the_unrounded_p():
    """The row log-sum-exp does not depend on ``round_to``: l sums the
    unrounded p, as the library's ``l_next = sum(p) + l_corr``."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _arrays(3, 200, 300, d=32))
    _, want = fa.flash_attention_plain(q, k, v, block_size=128,
                                       causal=True, return_lse=True)
    _, got = fa.flash_attention_plain(q, k, v, block_size=128, causal=True,
                                      return_lse=True,
                                      round_to=torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_round_to_matches_the_library_tpu_kernel(dtype, causal):
    """``flash_attention_plain(..., round_to=dtype, block_size=128)``
    against the library's Pallas TPU forward in interpret mode; causal
    alignment agrees at S_q = S_kv."""
    arrays = _arrays(0, 512, 512)
    with pltpu.force_tpu_interpret_mode():
        want = tpu_fa.flash_attention(
            *(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays),
            causal=causal, sm_scale=SCALE)
    want = np.asarray(want.astype(jnp.float32))
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in arrays)
    rounded = fa.flash_attention_plain(q, k, v, block_size=128,
                                       causal=causal, scale=SCALE,
                                       round_to=getattr(torch, dtype))
    unrounded = fa.flash_attention_plain(q, k, v, block_size=128,
                                         causal=causal, scale=SCALE)
    assert rounded.dtype == getattr(torch, dtype)
    top = np.abs(want).max()
    err = np.abs(rounded.float().numpy() - want).max() / top
    err_unrounded = np.abs(unrounded.float().numpy() - want).max() / top
    assert err <= TOL[dtype], err
    assert err < err_unrounded, (err, err_unrounded)
