"""Tests of the port that need an NVIDIA card (marker ``cuda``): the
hand-written conv-epilogue (K1), matmul-epilogue (K2) and flash-attention
(K3/K3', forward and backward) kernels against their plain versions on
CUDA tensors, the gradients of K1, K2 and K3 against their plain
versions' autograd and plain backward, their launch counts, and their refusals.
Without a card they skip; on the card run them with ``python -m pytest
-m cuda --noconftest tests/test_torch_cuda.py`` (the suite's conftest
imports the JAX package)."""
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import conv_epilogue as ce
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.kernels import matmul_epilogue as me

pytestmark = pytest.mark.cuda
_NONE = dict.fromkeys(("conv_epilogue", "matmul_epilogue", "flash_attention",
                       "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                      0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("act", ce.EPILOGUE_ACTS)
@pytest.mark.parametrize("shape,axis,vectors,with_res", [
    ((8, 64, 56, 56), 1, True, False),
    ((2, 2048, 7, 7), 1, False, True),
    ((77, 13), -1, True, True),
    ((3, 5, 7, 11), 2, True, True),
])
def test_kernel_matches_plain(cuda, shape, axis, vectors, with_res, act,
                              dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    c = shape[axis]
    s = (torch.rand(c, generator=gen, device=cuda) + 0.5).to(dtype) \
        if vectors else None
    b = (torch.randn(c, generator=gen, device=cuda) * 0.1).to(dtype) \
        if vectors else None
    r = torch.randn(*shape, generator=gen, device=cuda).to(dtype) \
        if with_res else None
    kernels.reset_launch_counts()
    got = ce.fused_conv_epilogue(x, s, b, r, channel_axis=axis,
                                 act_type=act)
    assert kernels.launch_counts() == dict(_NONE, conv_epilogue=1)
    want = ce.fused_conv_epilogue_plain(x, s, b, r, channel_axis=axis,
                                        act_type=act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 4, 3, 3, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        ce.fused_conv_epilogue(x.transpose(2, 3), res=x.transpose(2, 3))
    with pytest.raises(MXNetError, match="dtype"):
        ce.fused_conv_epilogue(x.double(), res=x.double())
    with pytest.raises(MXNetError, match="dtype"):
        ce.fused_conv_epilogue(x.double().requires_grad_(), res=x.double())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("act", ce.EPILOGUE_ACTS)
@pytest.mark.parametrize("shape,axis,vectors,with_res", [
    ((8, 64, 56, 56), 1, True, False),
    ((8, 256, 56, 56), 1, False, True),
    ((8, 512, 7, 7), 1, True, True),
    ((77, 13), -1, True, True),
])
def test_conv_epilogue_gradients_match_plain(cuda, shape, axis, vectors,
                                             with_res, act, dtype, tol):
    """K1 under autograd on the card: the kernel's forward (one launch,
    bit-equal to the plain version in float32), then the gradients of y,
    scale, bias and res against the plain version's autograd, within
    ``tol`` of each gradient's max |value|; the backward launches no
    kernel."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    c = shape[axis]

    def rnd(*s, scale=1.0, shift=0.0):
        return (torch.rand(*s, generator=gen, device=cuda) + shift
                if shift else torch.randn(*s, generator=gen, device=cuda)
                * scale).to(dtype)

    inputs = [rnd(*shape), rnd(c, shift=0.5) if vectors else None,
              rnd(c, scale=0.1) if vectors else None,
              rnd(*shape) if with_res else None]
    g = rnd(*shape)
    results = []
    for fn in (ce.fused_conv_epilogue, ce.fused_conv_epilogue_plain):
        leaves = [None if t is None else t.clone().requires_grad_()
                  for t in inputs]
        kernels.reset_launch_counts()
        out = fn(*leaves, channel_axis=axis, act_type=act)
        wrt = [t for t in leaves if t is not None]
        grads = torch.autograd.grad(out, wrt, g)
        launched = kernels.launch_counts()["conv_epilogue"]
        assert launched == (1 if fn is ce.fused_conv_epilogue else 0)
        results.append((out.detach(), grads))
    torch.cuda.synchronize()
    (got, got_grads), (want, want_grads) = results
    if dtype == torch.float32:
        assert torch.equal(got, want)
    for gg, ww in zip(got_grads, want_grads):
        assert gg.shape == ww.shape and gg.dtype == ww.dtype
        assert (gg.float() - ww.float()).abs().max().item() \
            <= tol * ww.float().abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("act", me.EPILOGUE_ACTS)
@pytest.mark.parametrize("shape,vec,p", [
    ((1024, 3072), "col", 0.0),
    ((1024, 768), "col", 0.1),
    ((8, 768), "col", 0.0),
    ((77, 5), "row", 0.5),
    ((3, 1), "col", 0.1),
])
def test_matmul_epilogue_kernel_matches_plain(cuda, shape, vec, p, act,
                                              dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    r, c = shape
    y = (torch.randn(r, c, generator=gen, device=cuda) * 2).to(dtype)
    b = (torch.randn(*((1, c) if vec == "col" else (r, 1)), generator=gen,
                     device=cuda) * 0.5).to(dtype)
    bits = torch.randint(0, 256, shape, generator=gen, device=cuda,
                         dtype=torch.uint8)
    kernels.reset_launch_counts()
    got = me.matmul_epilogue_2d(y, b, bits, act_type=act, p=p)
    assert kernels.launch_counts() == dict(_NONE, matmul_epilogue=1)
    want = me.matmul_epilogue_plain(y, b, bits, act_type=act, p=p)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == y.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if p == 0.0 and dtype == torch.float32:      # bit-equal without dropout
        assert torch.equal(got, want)


def test_dense_launches_matmul_epilogue(cuda):
    from mxnet_tpu_torch import gluon
    dense = gluon.nn.Dense(16, activation="gelu", flatten=False)
    dense.initialize(ctx=cuda, generator=torch.Generator(device=cuda))
    x = torch.randn(2, 3, 8, device=cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = dense(x)
    assert kernels.launch_counts()["matmul_epilogue"] == 1
    want = me.matmul_epilogue_plain(x @ dense.weight.t(), dense.bias,
                                    act_type="gelu")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_epilogue_refuses_what_it_does_not_take(cuda):
    y = torch.randn(4, 6, device=cuda)
    b = torch.randn(1, 6, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        me.matmul_epilogue_2d(y.t().contiguous().t(), b)
    with pytest.raises(MXNetError, match="dtype"):
        me.matmul_epilogue_2d(y.double(), b.double())
    with pytest.raises(MXNetError, match="bias"):
        me.matmul_epilogue_2d(y, b.half())


@pytest.mark.parametrize("act", me.EPILOGUE_ACTS)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_matmul_epilogue_gradients_match_plain(cuda, act, p):
    """K2 under autograd on the card: the kernel's forward, then dy and
    dbias against the plain version's autograd on the same bits, float32
    within 1e-5 of each gradient's max |value|."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    y = torch.randn(1024, 768, generator=gen, device=cuda)
    b = torch.randn(1, 768, generator=gen, device=cuda) * 0.5
    bits = torch.randint(0, 256, y.shape, generator=gen, device=cuda,
                         dtype=torch.uint8)
    g = torch.randn(y.shape, generator=gen, device=cuda)
    grads = []
    for fn in (me.matmul_epilogue_2d, me.matmul_epilogue_plain):
        ty, tb = y.clone().requires_grad_(), b.clone().requires_grad_()
        kernels.reset_launch_counts()
        out = fn(ty, tb, bits, act_type=act, p=p)
        grads.append(torch.autograd.grad(out, (ty, tb), g))
        launched = kernels.launch_counts()["matmul_epilogue"]
        assert launched == (1 if fn is me.matmul_epilogue_2d else 0)
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() \
            <= 1e-5 * want.abs().max().item()


# (B, H, S_q, S_kv, D, causal, form): "qkv" reads strided (B, S, H, D)
# views of one fused (B, S, 3HD) tensor, "bhsd" contiguous [B, H, S, D],
# "3d" [B, S, D]. S_q 127, 128 and 129 sit at the edge of the forward's
# 128-row CTA; S_q 300 against S_kv 200 under causal puts empty and
# non-empty rows in one CTA.
FLASH_CASES = [
    (4, 12, 4096, 4096, 64, False, "qkv"),
    (2, 3, 1100, 1100, 64, False, "bhsd"),
    (2, 3, 1100, 1100, 64, True, "bhsd"),
    (2, 3, 200, 1100, 64, True, "bhsd"),
    (2, 3, 1100, 200, 64, True, "bhsd"),
    (2, 3, 1100, 200, 64, False, "bhsd"),
    (1, 2, 1025, 1025, 16, True, "qkv"),
    (1, 2, 1, 1100, 128, False, "bhsd"),
    (1, 2, 7, 7, 128, True, "bhsd"),
    (2, 2, 300, 1030, 80, True, "bhsd"),
    (1, 2, 130, 257, 256, False, "bhsd"),
    (3, 1, 1100, 1100, 16, True, "3d"),
    (2, 3, 1100, 1100, 40, False, "bhsd"),
    (2, 3, 1100, 1100, 40, True, "bhsd"),
    (1, 2, 1100, 1100, 100, False, "bhsd"),
    (1, 2, 1100, 1100, 100, True, "bhsd"),
    (1, 2, 127, 1100, 64, True, "bhsd"),
    (1, 2, 128, 1100, 64, False, "bhsd"),
    (1, 2, 129, 1100, 64, True, "bhsd"),
    (1, 2, 300, 200, 64, True, "bhsd"),
]


def flash_inputs(case, dtype, device, seed=0):
    b, h, s_q, s_kv, d, _, form = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    if form == "qkv":
        assert s_q == s_kv
        qkv = rnd(b, s_q, 3 * h * d)
        return tuple(qkv[:, :, i * h * d:(i + 1) * h * d]
                     .reshape(b, s_q, h, d) for i in range(3))
    lead = (b,) if form == "3d" else (b, h)
    return rnd(*lead, s_q, d), rnd(*lead, s_kv, d), rnd(*lead, s_kv, d)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, tol):
    q, k, v = flash_inputs(case, dtype, cuda)
    causal, form = case[5], case[6]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        if form == "qkv":
            got = fa.flash_attention_bshd(q, k, v, causal=causal)
            want = fa.flash_attention_plain(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal).transpose(1, 2)
        else:
            got = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert kernels.launch_counts() == dict(_NONE, flash_attention=1)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= tol * scale, (err, scale)
    s_q, s_kv = case[2], case[3]
    if causal and s_q > s_kv:            # rows with no allowed key: zeros
        assert not got[..., :s_q - s_kv, :].any()


def test_fused_self_attention_launches_one_flash_attention(cuda):
    from mxnet_tpu_torch.ops import contrib
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    qkv = torch.randn(2, 1100, 3 * 96, generator=gen, device=cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = contrib.fused_self_attention(qkv, heads=3)
    assert kernels.launch_counts()["flash_attention"] == 1
    q, k, v = (qkv[:, :, i * 96:(i + 1) * 96].reshape(2, 1100, 3, 32)
               .transpose(1, 2) for i in range(3))
    want = fa.flash_attention_plain(q, k, v).transpose(1, 2) \
        .reshape(2, 1100, 96)
    torch.cuda.synchronize()
    assert got.shape == (2, 1100, 96)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 1100, 64, device=cuda)
    with pytest.raises(MXNetError, match="CPU or all on"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(MXNetError, match="256"):
        big = torch.randn(1, 1, 8, 320, device=cuda)
        fa.flash_attention(big, big, big)
    with pytest.raises(MXNetError, match="float16|dtype"):
        fa.flash_attention(q, q.half(), q)
    with pytest.raises(MXNetError, match="contiguous"):
        w = torch.randn(1, 2, 64, 1100, device=cuda).transpose(2, 3)
        fa.flash_attention(w, w, w)
    with pytest.raises(MXNetError, match="dtype"):
        fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(MXNetError, match="do not match|share"):
        fa.flash_attention(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_backward_kernels_match_plain(cuda, case, dtype,
                                                      tol):
    """dq, dk and dv of the backward kernels (one launch each of dK/dV
    and dQ) against ``flash_attention_bwd_plain`` on the forward's lse,
    within ``tol`` of each gradient's max |value|; the lse against the
    plain forward's."""
    q, k, v = flash_inputs(case, dtype, cuda)
    causal, form = case[5], case[6]
    if form == "qkv":
        qkv = q.as_strided(q.shape[:2] + (3 * q.shape[2] * q.shape[3],),
                           (q.stride(0), q.stride(1), 1)).clone()
        leaf = qkv.requires_grad_()
        out = fa.flash_attention_qkv(leaf, case[1], causal=causal)
        inputs = (leaf,)
        nd = [t.transpose(1, 2) for t in fa._split_qkv(qkv.detach(),
                                                        case[1])]
    else:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=causal)
        inputs = leaves
        nd = [t.detach() for t in leaves]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(out, inputs, dout)
    assert kernels.launch_counts() == dict(
        _NONE, flash_attention_bwd_dkv=1, flash_attention_bwd_dq=1)
    if form == "qkv":
        got = [g.transpose(1, 2) for g in fa._split_qkv(got[0], case[1])]
        plain_dout = dout.view(out.shape[:2] + (case[1], -1)).transpose(
            1, 2)
    else:
        plain_dout = dout
    p_out, lse = fa.flash_attention_plain(*nd, causal=causal,
                                          return_lse=True)
    want = fa.flash_attention_bwd_plain(*nd, p_out, lse, plain_dout,
                                        causal=causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), err
    s_q, s_kv = case[2], case[3]
    if causal and s_q > s_kv:            # rows with no allowed key: zeros
        assert not got[0][..., :s_q - s_kv, :].any()


def test_flash_attention_forward_writes_lse_only_for_a_gradient(cuda):
    q, k, v = flash_inputs((1, 2, 300, 1100, 64, True, "bhsd"),
                           torch.float32, cuda)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                                  return_lse=True)
    out, lse = fa._attend(q, k, v, True, fa.default_scale(64, q.dtype),
                          512, True, False)
    assert lse.shape == (1, 2, 300) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    _, none = fa._attend(q, k, v, True, 0.125, 512, False, False)
    assert none is None


@pytest.mark.parametrize("case", [
    (1, 2, 300, 1100, 64, True, "bhsd"),
    (1, 2, 129, 1100, 64, False, "bhsd"),
    (1, 2, 300, 200, 64, True, "bhsd"),
    (1, 2, 129, 1100, 128, True, "bhsd"),
    (1, 2, 200, 130, 256, True, "bhsd"),
])
def test_flash_attention_forward_lse_matches_plain(cuda, case):
    """The forward's fp32 row log-sum-exp against the plain version's
    ``return_lse=True``: within 1e-5 of max |lse| on the rows with an
    allowed key, +inf on exactly the rows without one. D 128 and 256 split
    a row's keys across warps (the row max and sum are combined through
    shared memory)."""
    q, k, v = flash_inputs(case, torch.float32, cuda)
    causal = case[5]
    _, want = fa.flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    _, lse = fa._attend(q, k, v, causal, fa.default_scale(case[4], q.dtype),
                        512, True, False)
    torch.cuda.synchronize()
    assert lse.shape == want.shape and lse.dtype == torch.float32
    finite = torch.isfinite(want)
    assert torch.equal(finite, torch.isfinite(lse))
    assert bool((lse[~finite] == torch.inf).all())
    err = (lse[finite] - want[finite]).abs().max().item()
    assert err <= 1e-5 * want[finite].abs().max().item(), err
