"""Flash attention in the port (K3/K3': mxnet_tpu_torch/kernels/
flash_attention.py, parallel/ring_attention.py and ops.contrib
flash_attention) against the JAX package on the CPU.

The JAX side is called directly (``_blockwise_impl``,
``attention_reference``, ``_flash_attention``), never through the Pallas
tier's mode or environment. Inputs are seeded numpy arrays of shape
(2, 3, S, 16) unless a case says otherwise; bf16 inputs are the same
arrays rounded to bf16 on both sides. Tolerances: float32 atol = rtol =
1e-5 (the online softmax sums in another order than the JAX scan, about
1e-7 relative), bfloat16 1e-2."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.contrib import _flash_attention
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.parallel import ring_attention as tra

# the module, not the function of the same name that mxnet_tpu.parallel
# exports
jra = importlib.import_module("mxnet_tpu.parallel.ring_attention")
DTYPES = [("float32", 1e-5), ("bfloat16", 1e-2)]


def _qkv(seed, s_q, s_kv, lead=(2, 3), d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(*lead, s_q, d).astype(np.float32),
            rng.randn(*lead, s_kv, d).astype(np.float32),
            rng.randn(*lead, s_kv, d).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _check(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,block_size", [(1, 512), (7, 3), (64, 16),
                                          (64, 512), (200, 48), (200, 512)])
def test_plain_matches_jax_blockwise(s, block_size, causal, dtype, tol):
    arrays = _qkv(s, s, s)
    want = jra._blockwise_impl(*_jax(arrays, dtype), block_size=block_size,
                               causal=causal)
    q, k, v = _torch(arrays, dtype)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = fa.flash_attention_plain(q, k, v, block_size=block_size,
                                       causal=causal)
        entry = tra.blockwise_attention(q, k, v, block_size=block_size,
                                        causal=causal)
    assert got.dtype == q.dtype and entry.dtype == q.dtype
    _check(got, want, tol)
    _check(entry, want, tol)
    assert kernels.launch_counts()["flash_attention"] == 0    # CPU path


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(7, 64), (64, 7), (200, 64),
                                      (37, 200), (1, 200), (200, 1)])
def test_unequal_lengths_match_jax(s_q, s_kv, causal, dtype, tol):
    arrays = _qkv(s_q * 1000 + s_kv, s_q, s_kv)
    jq, jk, jv = _jax(arrays, dtype)
    q, k, v = _torch(arrays, dtype)
    with torch.inference_mode():
        got = tra.blockwise_attention(q, k, v, block_size=48, causal=causal)
        ref = tra.attention_reference(q, k, v, causal=causal)
    _check(got, jra._blockwise_impl(jq, jk, jv, block_size=48,
                                    causal=causal), tol)
    _check(ref, jra.attention_reference(jq, jk, jv, causal=causal), tol)
    if causal and s_q > s_kv:           # rows with no allowed key are zeros
        empty = s_q - s_kv
        assert not got[..., :empty, :].any()
        assert not ref[..., :empty, :].any()
        assert got[..., empty:, :].abs().amax() > 0


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 7, 64, 200])
def test_attention_reference_matches_jax(s, causal, dtype, tol):
    arrays = _qkv(s + 7, s, s)
    want = jra.attention_reference(*_jax(arrays, dtype), causal=causal)
    with torch.inference_mode():
        got = tra.attention_reference(*_torch(arrays, dtype), causal=causal)
    _check(got, want, tol)


@pytest.mark.parametrize("causal", [False, True])
def test_three_d_inputs_ride_as_one_head(causal):
    arrays = _qkv(11, 50, 90, lead=(3,))
    want = jra._blockwise_impl(*_jax(arrays, "float32"), block_size=32,
                               causal=causal)
    with torch.inference_mode():
        got = tra.blockwise_attention(*_torch(arrays, "float32"),
                                      block_size=32, causal=causal)
        entry = fa.flash_attention(*_torch(arrays, "float32"),
                                   block_size=32, causal=causal)
    assert got.shape == (3, 50, 16)
    _check(got, want, 1e-5)
    _check(entry, want, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s_q,s_kv", [(1024, 1024), (1100, 1100),
                                      (64, 1100)])
def test_contrib_flash_attention_matches_jax(s_q, s_kv, causal):
    """Both sides of the dense/streaming threshold (S_kv 1024 is dense,
    1100 streams), default and explicit scale."""
    arrays = _qkv(s_kv, s_q, s_kv, lead=(1, 2))
    jq, jk, jv = _jax(arrays, "float32")
    q, k, v = _torch(arrays, "float32")
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = tcontrib.flash_attention(q, k, v, causal=causal)
        scaled = tcontrib.flash_attention(q, k, v, causal=causal,
                                          sm_scale=0.3, block_size=100)
    _check(got, _flash_attention(jq, jk, jv, causal=causal), 1e-5)
    _check(scaled, _flash_attention(jq, jk, jv, causal=causal, sm_scale=0.3,
                                    block_size=100), 1e-5)
    _check(tcontrib.flash_attention(q[0], k[0], v[0], causal=causal),
           _flash_attention(jq[0], jk[0], jv[0], causal=causal), 1e-5)
    assert kernels.launch_counts()["flash_attention"] == 0


def test_bshd_entry_reads_strided_views():
    """(B, S, H, D) views of a fused QKV give what the [B, H, S, D] entry
    gives on the transposed copies."""
    qkv = torch.from_numpy(
        np.random.RandomState(5).randn(2, 70, 3 * 24).astype(np.float32))
    q, k, v = (qkv[:, :, i * 24:(i + 1) * 24].reshape(2, 70, 3, 8)
               for i in range(3))
    assert q.stride() == (70 * 72, 72, 8, 1)
    for causal in (False, True):
        got = fa.flash_attention_bshd(q, k, v, block_size=16, causal=causal)
        want = fa.flash_attention_plain(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
            block_size=16, causal=causal).transpose(1, 2)
        assert got.shape == (2, 70, 3, 8) and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_default_scale_rounds_in_the_input_dtype():
    """``1 / sqrt(D)`` as the JAX package's default: rounded in q's
    dtype, so bf16 at D 128 uses bf16(1 / bf16(sqrt(128)))."""
    for d, dtype in ((16, "float32"), (128, "float32"), (128, "bfloat16"),
                     (80, "float16")):
        want = 1.0 / jnp.sqrt(d).astype(getattr(jnp, dtype))
        assert fa.default_scale(d, getattr(torch, dtype)) == float(want)
    arrays = _qkv(3, 20, 30, lead=(1, 1), d=128)
    _check(tra.blockwise_attention(*_torch(arrays, "bfloat16"), block_size=8),
           jra._blockwise_impl(*_jax(arrays, "bfloat16"), block_size=8),
           1e-2)


def test_mixed_devices_raise():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(MXNetError, match="CPU or all on"):
        fa.flash_attention(q, q, q.to("meta"))
