"""The port's matmul-epilogue kernel module (mxnet_tpu_torch/kernels/
matmul_epilogue.py) against the JAX package's K2 on the CPU: its plain
version and its 2-D entry against the Pallas kernel in interpret mode and
the registered reference with the same explicit uint8 dropout bits, the
N-D entry against the JAX N-D wrapper, ``keep_threshold`` on a table of
rates, and the gradients of its ``autograd.Function`` against ``jax.vjp``
of the reference and of the Pallas kernel's custom VJP (``_me_drop`` /
``_me_nodrop``) with the bits of the JAX ``dropout_bits``.

Tolerances: float32 at atol = rtol = 1e-5 (the registered tolerance of
the JAX kernel; with dropout the reference divides by 1 - p and the
Pallas kernel multiplies by its reciprocal, which may differ by an ulp);
bfloat16 at atol = rtol = 1e-2, about one bf16 ulp. The JAX functions
are called directly, so no Pallas mode or environment state is read."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas.kernels import (_matmul_epilogue_pallas,
                                      _matmul_epilogue_ref, _me_drop,
                                      _me_nodrop, dropout_bits,
                                      fused_matmul_epilogue as jax_fused,
                                      keep_threshold as jax_keep_threshold)
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import matmul_epilogue as me
from mxnet_tpu_torch.ops import contrib as tcontrib

ACTS = ("identity", "relu", "gelu", "tanh", "sigmoid")


def _case(seed, rows, cols, vec):
    rng = np.random.RandomState(seed)
    y = (rng.randn(rows, cols) * 2).astype(np.float32)
    bias = (rng.randn(*((1, cols) if vec == "col" else (rows, 1)))
            * 0.5).astype(np.float32)
    bits = rng.randint(0, 256, size=(rows, cols)).astype(np.uint8)
    return y, bias, bits


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("vec", ["col", "row"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_and_2d_entry_match_jax_kernel_fp32(act, vec, p):
    y, b, bits = _case(0, 16, 136, vec)
    ty, tb, tbits = (torch.from_numpy(a) for a in (y, b, bits))
    jy, jb, jbits = jnp.asarray(y), jnp.asarray(b), jnp.asarray(bits)
    want_kernel = _matmul_epilogue_pallas(jy, jb, jbits, interpret=True,
                                          act_type=act, p=p)
    want_ref = _matmul_epilogue_ref(jy, jb, jbits, act_type=act, p=p)
    for got in (me.matmul_epilogue_plain(ty, tb, tbits, act_type=act, p=p),
                me.matmul_epilogue_2d(ty, tb, tbits, act_type=act, p=p)):
        assert got.dtype == torch.float32 and got.shape == (16, 136)
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                       atol=1e-5)
    if p > 0:                       # the mask is the reference's mask
        dropped = bits < jax_keep_threshold(p)
        assert dropped.any() and (_f32(got)[dropped] == 0).all()


@pytest.mark.parametrize("p", [0.0, 0.5])
@pytest.mark.parametrize("act", ["identity", "gelu", "tanh"])
def test_plain_matches_jax_kernel_bf16(act, p):
    y, b, bits = _case(1, 24, 128, "col")
    ty = torch.from_numpy(y).bfloat16()
    tb = torch.from_numpy(b).bfloat16()
    jy = jnp.asarray(y, jnp.bfloat16)
    jb = jnp.asarray(b, jnp.bfloat16)
    got = me.matmul_epilogue_plain(ty, tb, torch.from_numpy(bits),
                                   act_type=act, p=p)
    assert got.dtype == torch.bfloat16
    for want in (_matmul_epilogue_pallas(jy, jb, jnp.asarray(bits),
                                         interpret=True, act_type=act, p=p),
                 _matmul_epilogue_ref(jy, jb, jnp.asarray(bits),
                                      act_type=act, p=p)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-2,
                                   atol=1e-2)


# the JAX N-D wrapper flattens to (-1, C); a minor dim under 8 goes to
# its reference (the Pallas supports gate), which the port must equal too
@pytest.mark.parametrize("shape", [(2, 5, 48), (7, 5), (3, 4, 6, 1),
                                   (130,)])
@pytest.mark.parametrize("act", [None, "gelu", "sigmoid"])
def test_nd_entry_matches_jax(shape, act):
    rng = np.random.RandomState(len(shape) + shape[-1])
    y = rng.randn(*shape).astype(np.float32)
    b = (rng.randn(shape[-1]) * 0.3).astype(np.float32)
    got = me.fused_matmul_epilogue(torch.from_numpy(y), torch.from_numpy(b),
                                   act_type=act)
    want = jax_fused(jnp.asarray(y), jnp.asarray(b), act_type=act)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    no_bias = me.fused_matmul_epilogue(torch.from_numpy(y), None,
                                       act_type=act)
    np.testing.assert_allclose(
        _f32(no_bias), _f32(jax_fused(jnp.asarray(y), None, act_type=act)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_nd_entry_dropout_matches_jax_reference(p):
    rng = np.random.RandomState(3)
    y = rng.randn(2, 3, 40).astype(np.float32)
    b = (rng.randn(40) * 0.3).astype(np.float32)
    bits = rng.randint(0, 256, size=y.shape).astype(np.uint8)
    got = me.fused_matmul_epilogue(torch.from_numpy(y), torch.from_numpy(b),
                                   act_type="gelu", p=p,
                                   bits=torch.from_numpy(bits))
    want = _matmul_epilogue_ref(jnp.asarray(y.reshape(6, 40)),
                                jnp.asarray(b.reshape(1, 40)),
                                jnp.asarray(bits.reshape(6, 40)),
                                act_type="gelu", p=p)
    np.testing.assert_allclose(_f32(got).reshape(6, 40), _f32(want),
                               rtol=1e-5, atol=1e-5)


# rates whose p * 256 lands on .5 exercise Python's round-half-to-even
@pytest.mark.parametrize("p", [0.0, 0.001, 0.5 / 256, 1.5 / 256, 2.5 / 256,
                               0.1, 0.125, 0.3, 0.5, 0.9, 254.5 / 256,
                               255.5 / 256, 0.999, 1.0])
def test_keep_threshold_matches_jax(p):
    assert me.keep_threshold(p) == jax_keep_threshold(p)
    assert kernels.keep_threshold(p) == jax_keep_threshold(p)


def test_keep_threshold_rounds_half_to_even():
    assert [me.keep_threshold(k / 256) for k in (0.5, 1.5, 2.5, 3.5)] \
        == [0, 2, 2, 4]
    assert me.keep_threshold(1.0) == 255


def test_wrapper_rejects_what_it_cannot_compute():
    y = torch.zeros(4, 6)
    with pytest.raises(MXNetError, match="act_type"):
        me.matmul_epilogue_2d(y, torch.zeros(1, 6), act_type="softsign")
    with pytest.raises(MXNetError, match="bias"):
        me.matmul_epilogue_2d(y, torch.zeros(4, 6))
    with pytest.raises(MXNetError, match="2-D"):
        me.matmul_epilogue_2d(torch.zeros(2, 2, 6), torch.zeros(1, 6))
    with pytest.raises(MXNetError, match="uint8"):
        me.matmul_epilogue_2d(y, torch.zeros(1, 6), torch.zeros(4, 6),
                              p=0.5)
    with pytest.raises(MXNetError, match="bits"):
        me.matmul_epilogue_2d(y, torch.zeros(1, 6),
                              torch.zeros(4, 5, dtype=torch.uint8), p=0.5)
    with pytest.raises(MXNetError, match="outside"):
        me.matmul_epilogue_2d(y, torch.zeros(1, 6), p=1.0)
    with pytest.raises(MXNetError, match="elements"):
        me.fused_matmul_epilogue(y, torch.zeros(5))


@pytest.mark.parametrize("vec", ["col", "row"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("act", ACTS)
def test_gradients_match_jax_vjp(act, p, vec):
    """dy and dbias of the 2-D entry against ``jax.vjp`` of the
    reference and of the Pallas kernel's custom VJP (interpret mode),
    with the bits of ``dropout_bits``; float32 within 1e-5 of each
    gradient's max |value| (K2's registered tolerance)."""
    y, b, _ = _case(2, 16, 136, vec)
    g = np.random.RandomState(3).randn(16, 136).astype(np.float32)
    bits = np.array(dropout_bits(jax.random.key(5), y.shape, layer=1))
    jy, jb, jbits, jg = (jnp.asarray(a) for a in (y, b, bits, g))
    if p > 0:
        kernel = lambda a, c: _me_drop(act, p, True, None, a, c, jbits)
    else:
        kernel = lambda a, c: _me_nodrop(act, True, None, a, c)
    wants = [jax.vjp(fn, jy, jb)[1](jg) for fn in (
        kernel, lambda a, c: _matmul_epilogue_ref(a, c, jbits, act_type=act,
                                                  p=p))]
    ty = torch.from_numpy(y).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = me.matmul_epilogue_2d(ty, tb, torch.from_numpy(bits), act_type=act,
                                p=p)
    got = torch.autograd.grad(out, (ty, tb), torch.from_numpy(g))
    for want in wants:
        for gt, w in zip(got, want):
            w = _f32(w)
            assert tuple(gt.shape) == w.shape
            np.testing.assert_allclose(_f32(gt), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    if p > 0:                       # dropped elements get no gradient
        assert (_f32(got[0])[bits < jax_keep_threshold(p)] == 0).all()


def test_nd_entry_gradient_reaches_a_vector_bias():
    """The N-D entry's bias of C elements gets the fp32 sum over every
    other axis, as JAX's N-D wrapper gives it."""
    rng = np.random.RandomState(8)
    y = rng.randn(2, 3, 40).astype(np.float32)
    b = (rng.randn(40) * 0.3).astype(np.float32)
    g = rng.randn(2, 3, 40).astype(np.float32)
    _, pull = jax.vjp(lambda a, c: jax_fused(a, c, act_type="gelu"),
                      jnp.asarray(y), jnp.asarray(b))
    want = pull(jnp.asarray(g))
    ty = torch.from_numpy(y).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = me.fused_matmul_epilogue(ty, tb, act_type="gelu")
    got = torch.autograd.grad(out, (ty, tb), torch.from_numpy(g))
    for gt, w in zip(got, want):
        np.testing.assert_allclose(_f32(gt), _f32(w), rtol=0,
                                   atol=1e-5 * np.abs(_f32(w)).max())


def test_contrib_training_draws_bits_on_the_input_device():
    """``ops.contrib.matmul_epilogue`` in training with p > 0 draws one
    uint8 per element and applies them as the plain version does; in
    predict mode it draws nothing."""
    y = torch.randn(200, 300)
    b = torch.randn(300)
    with trandom.bits_tape() as tape:
        out = tcontrib.matmul_epilogue(y, b, act_type="identity", p=0.1,
                                       training=True)
        tcontrib.matmul_epilogue(y, b, act_type="identity", p=0.1)
    (bits,) = tape.drawn
    assert bits.dtype == torch.uint8 and bits.shape == y.shape
    want = me.matmul_epilogue_plain(y, b.reshape(1, 300), bits,
                                    act_type="identity", p=0.1)
    assert torch.equal(out, want)
    share = float((out != 0).float().mean())
    assert abs(share - 0.9) < 0.01


def test_cpu_path_never_counts_a_launch():
    kernels.reset_launch_counts()
    y = torch.randn(4, 6)
    me.fused_matmul_epilogue(y, torch.ones(6), act_type="gelu")
    me.matmul_epilogue_2d(y, torch.ones(4, 1), act_type="tanh")
    me.matmul_epilogue_plain(y, torch.ones(1, 6))
    assert kernels.launch_counts() == {"conv_epilogue": 0,
                                       "matmul_epilogue": 0,
                                       "flash_attention": 0,
                                       "flash_attention_bwd_dkv": 0,
                                       "flash_attention_bwd_dq": 0}


def test_library_name_hashes_the_source_and_every_header(tmp_path,
                                                         monkeypatch):
    from mxnet_tpu_torch.kernels import _build
    assert _build.SOURCES == ("conv_epilogue", "matmul_epilogue",
                              "flash_attention", "flash_attention_bwd")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert first == _build._target("k")
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert _build._target("k") != first       # a changed header rebuilds
