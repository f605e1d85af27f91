"""The port's conv-epilogue kernel module (mxnet_tpu_torch/kernels/
conv_epilogue.py) against the JAX package's K1: its plain version against
the Pallas kernel in interpret mode and the registered reference, and
the N-D wrapper against the JAX N-D wrapper, on the CPU.

Tolerances: float32 at atol = rtol = 1e-5 (the registered tolerance of
the JAX kernel); bfloat16 at atol = rtol = 1e-2, about one bf16 ulp,
because the two frameworks may round an fp32 intermediate differently
before the final cast."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas.kernels import (_conv_epilogue_pallas,
                                      _conv_epilogue_ref,
                                      fused_conv_epilogue as jax_fused)
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import conv_epilogue as ce

ACTS = ("identity", "relu", "gelu", "tanh", "sigmoid")
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _case(seed, rows, cols, vec, with_res):
    rng = np.random.RandomState(seed)
    shape = (1, cols) if vec == "col" else (rows, 1)
    y = rng.randn(rows, cols).astype(np.float32)
    scale = (rng.rand(*shape) + 0.5).astype(np.float32)
    bias = (rng.randn(*shape) * 0.1).astype(np.float32)
    res = rng.randn(rows, cols).astype(np.float32) if with_res else None
    return y, scale, bias, res


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("vec", ["col", "row"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jax_kernel_fp32(act, vec, with_res):
    y, s, b, r = _case(0, 16, 136, vec, with_res)
    got = ce.conv_epilogue_plain(*(_torch(a, "float32") for a in (y, s, b, r)),
                                 act_type=act)
    args = [_jax(a, "float32") for a in (y, s, b, r)]
    want_kernel = _conv_epilogue_pallas(*args, interpret=True, act_type=act)
    want_ref = _conv_epilogue_ref(*args, act_type=act)
    assert got.dtype == torch.float32 and got.shape == (16, 136)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("vec,with_res", [("col", True), ("row", False)])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jax_kernel_bf16(act, vec, with_res):
    y, s, b, r = _case(1, 24, 128, vec, with_res)
    got = ce.conv_epilogue_plain(
        *(_torch(a, "bfloat16") for a in (y, s, b, r)), act_type=act)
    args = [_jax(a, "bfloat16") for a in (y, s, b, r)]
    want = _conv_epilogue_pallas(*args, interpret=True, act_type=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        _f32(got), _f32(_conv_epilogue_ref(*args, act_type=act)),
        rtol=1e-2, atol=1e-2)


# (shape, channel_axis, vectors?, residual?) — NCHW row broadcast, channel
# last, another axis, the residual-only form with a minor dim of 7 (which
# the JAX tier sends to its reference), a 1-D input and a 2-D row form
_ND_CASES = [
    ((2, 6, 5, 7), 1, True, False),
    ((2, 6, 5, 7), 1, True, True),
    ((2, 5, 7, 6), -1, True, True),
    ((2, 3, 4, 5), 2, True, True),
    ((2, 8, 7, 7), 1, False, True),
    ((3, 7), 0, True, False),
    ((9,), 0, True, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "gelu", "sigmoid"])
@pytest.mark.parametrize("shape,axis,vectors,with_res", _ND_CASES)
def test_nd_wrapper_matches_jax(shape, axis, vectors, with_res, act, dtype):
    rng = np.random.RandomState(len(shape) * 10 + axis % 7)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[axis]
    s = (rng.rand(c) + 0.5).astype(np.float32) if vectors else None
    b = (rng.randn(c) * 0.1).astype(np.float32) if vectors else None
    r = rng.randn(*shape).astype(np.float32) if with_res else None
    got = ce.fused_conv_epilogue(
        *(_torch(a, dtype) for a in (x, s, b, r)), channel_axis=axis,
        act_type=act)
    want = jax_fused(*(_jax(a, dtype) for a in (x, s, b, r)),
                     channel_axis=axis, act_type=act)
    assert tuple(got.shape) == shape
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_one_missing_vector_means_ones_or_zeros():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 4, 3, 3).astype(np.float32))
    s = torch.from_numpy((rng.rand(4) + 0.5).astype(np.float32))
    got = ce.fused_conv_epilogue(x, scale=s, channel_axis=1,
                                 act_type="identity")
    torch.testing.assert_close(got, x * s.reshape(1, 4, 1, 1), rtol=0,
                               atol=0)
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    got = ce.fused_conv_epilogue(x, bias=b, channel_axis=1,
                                 act_type="identity")
    torch.testing.assert_close(got, x + b.reshape(1, 4, 1, 1), rtol=0,
                               atol=0)


def test_wrapper_rejects_what_it_cannot_compute():
    x = torch.zeros(2, 4, 3, 3)
    with pytest.raises(MXNetError, match="act_type"):
        ce.fused_conv_epilogue(x, res=x, act_type="softsign")
    with pytest.raises(MXNetError, match="res"):
        ce.fused_conv_epilogue(x, res=torch.zeros(2, 4, 3, 2))
    with pytest.raises(MXNetError, match="elements"):
        ce.fused_conv_epilogue(x, scale=torch.ones(3), bias=torch.zeros(3),
                               channel_axis=1)


def test_cpu_path_never_counts_a_launch():
    kernels.reset_launch_counts()
    x = torch.randn(2, 4, 3, 3)
    ce.fused_conv_epilogue(x, torch.ones(4), torch.zeros(4), x,
                           channel_axis=1)
    ce.fused_conv_epilogue(x, res=x)
    ce.conv_epilogue_plain(x, act_type="tanh")
    assert kernels.launch_counts() == {"conv_epilogue": 0}
