"""Tests of the port that need an NVIDIA card (marker ``cuda``): the
hand-written conv-epilogue (K1), matmul-epilogue (K2) and flash-attention
(K3/K3', forward and backward) kernels against their plain versions on
CUDA tensors, the gradients of K1, K2 and K3 against their plain
versions' autograd and plain backward, their launch counts, and their refusals;
then CUDA graphs: each kernel captured and replayed against its launch,
hybridized narrow models against eager twins, the server's graphed
predictors, and ``parallel.ShardedTrainer``'s whole step as one graph
(an fp16 overflow skipped inside it; graphed steps against eager ones,
for every optimizer with a functional rule; ``run_steps`` windows against
their eager loop and against ``step()`` calls); a capture's launch count
beside another thread's launches, and the decode engine's programs as
CUDA graphs.
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
                                       (torch.bfloat16, 1e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("act", me.EPILOGUE_ACTS)
@pytest.mark.parametrize("shape,vec,p,offset", [
    ((1024, 3072), "col", 0.0, 0),
    ((1024, 768), "col", 0.1, 0),
    ((8, 768), "col", 0.0, 0),
    ((77, 5), "row", 0.5, 0),
    ((3, 1), "col", 0.1, 0),
    ((64, 772), "col", 0.1, 0),
    ((64, 768), "col", 0.1, 1),
    ((64, 768), "row", 0.0, 1),
])
def test_matmul_epilogue_kernel_matches_plain(cuda, shape, vec, p, offset,
                                              act, dtype, tol):
    """The kernel against its plain version. C 3072 and 768 take the
    vector pass (one 16-byte vector of y per thread); C 772 (not a
    multiple of 8 in 16 bits), C 5 and 1, and a contiguous y that starts
    at an odd element offset (``offset`` 1) take the element pass."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    r, c = shape
    y = (torch.randn(r * c + offset, generator=gen, device=cuda) * 2).to(
        dtype)[offset:].view(r, c)
    assert y.is_contiguous()
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
        me.matmul_epilogue_2d(y, b.double())
    # a bias at another floating dtype than y's is read at its own
    got = me.matmul_epilogue_2d(y, b.half())
    assert torch.equal(got, me.matmul_epilogue_plain(y, b.half()))


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
# "3d" [B, S, D]. S_q 127, 128 and 129 sit at the edge of a 128-row CTA
# (the fp32 forward, the backward), S_q 65 at that of the 16-bit forward's
# 64-row CTA at D 64; S_q 300 against S_kv 200 under causal puts empty and
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
    (1, 2, 65, 1100, 64, True, "bhsd"),
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
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, tol,
                                              record_property):
    """The forward kernel against ``flash_attention_plain``, within
    ``tol`` of max |out|. The 16-bit kernels round p to the input dtype
    before p v, as the JAX library's TPU forward does against the running
    max of each 128-key block: they are also held, within the same
    tolerance, against the plain version with ``round_to`` the input dtype
    and ``block_size=128``, and that error is recorded
    (``rel_vs_round_to``)."""
    q, k, v = flash_inputs(case, dtype, cuda)
    causal, form = case[5], case[6]
    sixteen = dtype != torch.float32
    kernels.reset_launch_counts()
    with torch.inference_mode():
        if form == "qkv":
            got = fa.flash_attention_bshd(q, k, v, causal=causal)

            def plain(**kw):
                return fa.flash_attention_plain(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, **kw).transpose(1, 2)
        else:
            got = fa.flash_attention(q, k, v, causal=causal)

            def plain(**kw):
                return fa.flash_attention_plain(q, k, v, causal=causal, **kw)
        assert kernels.launch_counts() == dict(_NONE, flash_attention=1)
        want = plain()
        rounded = plain(block_size=128, round_to=dtype) if sixteen else None
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= tol * scale, (err, scale)
    if sixteen:
        top = rounded.float().abs().max().item()
        err = (got.float() - rounded.float()).abs().max().item()
        assert err <= tol * top, (err, top)
        record_property("rel_vs_round_to", err / top)
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
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_backward_kernels_match_plain(cuda, case, dtype,
                                                      tol, record_property):
    """dq, dk and dv of the backward kernels (one launch each of dK/dV
    and dQ) against ``flash_attention_bwd_plain`` on the forward's lse,
    within ``tol`` of each gradient's max |value|. The 16-bit kernels
    round p and scale * ds to the input dtype before the gradient
    products, as the TPU kernels do: they are also held, within the same
    tolerance, against the plain version with ``round_to`` the input
    dtype, and that error is recorded (``rel_vs_round_to``)."""
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
    rounded = [None] * 3 if dtype == torch.float32 else \
        fa.flash_attention_bwd_plain(*nd, p_out, lse, plain_dout,
                                     causal=causal, round_to=dtype)
    torch.cuda.synchronize()
    worst = 0.0
    for g, w, r in zip(got, want, rounded):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), err
        if r is not None:
            top = r.float().abs().max().item()
            err = (g.float() - r.float()).abs().max().item()
            assert err <= tol * top, err
            worst = max(worst, err / top)
    if dtype != torch.float32:
        record_property("rel_vs_round_to", worst)
    s_q, s_kv = case[2], case[3]
    if causal and s_q > s_kv:            # rows with no allowed key: zeros
        assert not got[0][..., :s_q - s_kv, :].any()


def test_flash_attention_bwd_smem_is_16_bit_for_16_bit_inputs(cuda):
    """The 16-bit backward (dtype codes 1 and 2) keeps its resident rows
    and its streamed tiles as 16-bit values, with no tf32 hi or lo words:
    at D 64 a CTA holds 1024 bytes of alignment slack, 128 resident rows
    of K and V (dK/dV) or q and dout (dQ), a three-stage ring of two 128 x
    64 tiles and, in dK/dV, the ring's lse and delta. The fp32 kernels
    keep their 3xTF32 layout: 4-byte hi and lo words for 128 resident
    rows, and streamed tiles of 64 rows."""
    import ctypes
    fn = fa._bwd_lib().flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    resident, ring = 2 * 128 * 64 * 2, 3 * 2 * 128 * 64 * 2
    want = {0: 1024 + resident + ring + 3 * 2 * 128 * 4,
            1: 1024 + resident + ring}
    for which in (0, 1):
        for code in (1, 2):
            assert fn(which, code, 64) == want[which]
        # fp32: hi and lo words [128][68] for each of two resident operands
        assert fn(which, 0, 64) >= 4 * 128 * 68 * 4


def test_flash_attention_smem_is_16_bit_for_16_bit_inputs(cuda):
    """The 16-bit forward (dtype codes 1 and 2) keeps q and the streamed
    K and V tiles as 16-bit values, with no tf32 hi or lo words: at D 64 a
    CTA holds 1024 bytes of alignment slack, 64 rows of q and a
    three-stage ring of two 128 x 64 tiles (two CTAs share an SM); at D
    128 128 rows of q and a three-stage ring of two 128 x 128 tiles; at D
    256 (mma.sync) 64 rows of q and a three-stage ring of two 32-row
    tiles, rows of 264 16-bit elements. The fp32 kernel keeps its 3xTF32
    layout: 4-byte hi and lo words for 128 rows of q at D 64."""
    import ctypes
    fn = fa._lib().flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    want = {64: 1024 + 64 * 64 * 2 + 3 * 2 * 128 * 64 * 2,
            128: 1024 + 128 * 128 * 2 + 3 * 2 * 128 * 128 * 2,
            256: (3 * 2 * 32 + 64) * 264 * 2}
    for d, bytes_ in want.items():
        for code in (1, 2):
            assert fn(code, d) == bytes_
            assert fn(code, d - 1) == bytes_     # D rides in the next DP
    assert fn(0, 64) >= 2 * 128 * 68 * 4


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [
    (1, 2, 300, 1100, 64, True, "bhsd"),
    (1, 2, 129, 1100, 64, False, "bhsd"),
    (1, 2, 300, 200, 64, True, "bhsd"),
    (1, 2, 129, 1100, 128, True, "bhsd"),
    (1, 2, 200, 130, 256, True, "bhsd"),
])
def test_flash_attention_forward_lse_matches_plain(cuda, case, dtype):
    """The forward's fp32 row log-sum-exp against the plain version's
    ``return_lse=True``: within 1e-5 of max |lse| on the rows with an
    allowed key, +inf on exactly the rows without one. In fp32, D 128 and
    256 split a row's keys across warps (the row max and sum are combined
    through shared memory). In 16 bits l sums the unrounded p, so lse is
    the same function as in fp32: the scores are exact products of 16-bit
    values summed in fp32, and the kernel's exp2 with the scale folded
    into log2 e differs from expf by a few ulps, far below 1e-5."""
    q, k, v = flash_inputs(case, dtype, cuda)
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


# -- CUDA graphs: the kernels captured, hybridize() on narrow models ---------
from mxnet_tpu_torch import autograd as tag            # noqa: E402
from mxnet_tpu_torch import initializer as tinit       # noqa: E402
from mxnet_tpu_torch import random as trandom          # noqa: E402
from mxnet_tpu_torch.gluon import cached_graph as cg   # noqa: E402


def _graph(device, fn, generators=()):
    """``fn`` warmed up and captured by the port's backend; returns the
    graph and the static output, and the bits the capture drew."""
    backend = cg.CudaGraphs()
    backend.warm_up(fn, device)
    with trandom.draws(keep_states=False) as seen:
        graph, out = backend.capture(fn, backend.new_pool(device),
                                     list(generators), device)
    return graph, out, seen.drawn


def test_conv_epilogue_replays_equal_its_launch(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn(8, 64, 56, 56, generator=gen, device=cuda)
    s = torch.rand(64, generator=gen, device=cuda) + 0.5
    b = torch.randn(64, generator=gen, device=cuda)
    r = torch.randn(8, 64, 56, 56, generator=gen, device=cuda)

    def fn():
        return ce.fused_conv_epilogue(x, s, b, r, channel_axis=1,
                                      act_type="relu")

    graph, out, _ = _graph(cuda, fn)
    for _ in range(2):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
        graph.replay()
        assert torch.equal(out, fn())


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_matmul_epilogue_replays_equal_its_launch(cuda, p):
    """K2 in a graph, p 0 and p 0.1 with bits drawn inside the graph from
    a registered generator: each replay equals the eager kernel on the
    bits that replay drew, and two replays draw different bits."""
    from mxnet_tpu_torch.ops import contrib
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    y = torch.randn(1024, 768, generator=gen, device=cuda)
    bias = torch.randn(768, generator=gen, device=cuda)
    drop = trandom.generator(5, cuda)

    def fn():
        return contrib.matmul_epilogue(y, bias, act_type="gelu", p=p,
                                       training=True, generator=drop)

    graph, out, drawn = _graph(cuda, fn, [drop])
    assert len(drawn) == (1 if p else 0)
    seen = []
    for _ in range(2):
        y.copy_(torch.randn(y.shape, generator=gen, device=cuda))
        graph.replay()
        bits = drawn[0].clone() if p else None
        want = me.fused_matmul_epilogue(y, bias, act_type="gelu", p=p,
                                        bits=bits)
        assert torch.equal(out, want)
        seen.append(bits)
    if p:
        assert not torch.equal(*seen)


def test_flash_attention_and_backward_replay_equal_their_launches(cuda):
    """K3 and both K3 backward kernels in one graph (forward, then
    ``autograd.grad``): each replay equals the eager kernels."""
    q, k, v = (t.clone().requires_grad_()
               for t in flash_inputs((2, 3, 1100, 1100, 64, True, "bhsd"),
                                     torch.float32, cuda))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    dout = torch.randn(q.shape, generator=gen, device=cuda)

    def fn():
        out = fa.flash_attention(q, k, v, causal=True)
        return (out,) + torch.autograd.grad(out, (q, k, v), dout)

    graph, static, _ = _graph(cuda, fn)
    for _ in range(2):
        with torch.no_grad():
            for t in (q, k, v, dout):
                t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
        kernels.reset_launch_counts()
        graph.replay()
        assert not any(kernels.launch_counts().values())   # no wrapper ran
        for got, want in zip(static, fn()):
            assert torch.equal(got, want)


def test_capture_counts_only_its_own_launches(cuda):
    """A program records the launches made into its capture (K3's forward
    on the capturing thread, both K3-bwd kernels on the autograd engine's
    thread) while another thread launches K2 eagerly and copies its output
    to the host the whole time (allowed: the capture is thread_local);
    those launches stay in the counts and out of the program."""
    import threading

    from mxnet_tpu_torch.gluon import HybridBlock

    class Attn(HybridBlock):
        def forward(self, q, k, v):
            return fa.flash_attention(q, k, v, causal=True)

    q, k, v = (t.clone().requires_grad_()
               for t in flash_inputs((1, 2, 1100, 1100, 64, True, "bhsd"),
                                     torch.float32, cuda))
    y = torch.randn(256, 768, device=cuda)
    bias = torch.randn(768, device=cuda)
    stop, spun = threading.Event(), [0]

    def spin():                     # a server's worker: launch, copy out
        while not stop.is_set():
            me.fused_matmul_epilogue(y, bias, act_type="relu").cpu()
            spun[0] += 1

    kernels.reset_launch_counts()
    other = threading.Thread(target=spin)
    other.start()
    try:
        prog = cg.capture(cg.CudaGraphs(), Attn(), (q, k, v), {}, True, cuda)
    finally:
        stop.set()
        other.join()
    assert prog.fwd_launches == {"flash_attention": 1}
    assert prog.bwd_launches == {"flash_attention_bwd_dkv": 1,
                                 "flash_attention_bwd_dq": 1}
    assert kernels.launch_counts() == dict(   # the 2 warm-up passes
        _NONE, matmul_epilogue=spun[0], flash_attention=2,
        flash_attention_bwd_dkv=2, flash_attention_bwd_dq=2)
    prog.release()


def _narrow_resnet(cuda):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [8, 16, 32, 64, 128], classes=10)
    net.initialize(tinit.Xavier(), ctx=cuda,
                   generator=trandom.generator(0))
    net(torch.zeros(2, 3, 32, 32, device=cuda))
    return net


def _narrow_bert(cuda, dropout=0.0, max_length=64):
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.BERTModel(num_layers=2, units=64, hidden_size=128,
                         num_heads=2, max_length=max_length, vocab_size=100,
                         dropout=dropout, use_pooler=False,
                         use_classifier=False)
    net.initialize(tinit.Normal(0.02), ctx=cuda,
                   generator=trandom.generator(0))
    net(torch.zeros(1, 4, dtype=torch.int32, device=cuda))
    return net


def _twin(net, make, cuda):
    other = make(cuda)
    other.load_dict({k: v.detach().cpu().numpy()
                     for k, v in net.collect_params().items()})
    return other


def _step(net, x, y, loss_fn, pick=None):
    with tag.record():
        out = net(x)
        loss = loss_fn(out if pick is None else out[pick], y)
    tag.backward(loss)
    return loss.detach()


def _close_rel(got, want, tol, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _same_step(a, b, tol):
    """Every gradient (a parameter the step did not reach: zeros in a
    graphed block, as the reference's VJP gives, None in an eager one)
    and every buffer of ``a`` and ``b`` within ``tol`` of max |value|."""
    pa, pb = a.collect_params(), b.collect_params()
    for name in pa:
        if pa[name].requires_grad:
            ga, gb = (torch.zeros_like(p) if p.grad is None else p.grad
                      for p in (pa[name], pb[name]))
            _close_rel(ga, gb, tol, f"grad {name}")
        else:
            _close_rel(pa[name], pb[name], tol, name)


@pytest.fixture
def deterministic():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


def test_hybridized_resnet_predicts_and_trains_as_eager(cuda, deterministic):
    """The narrow ResNet V1 hybridized against an eager twin: predict
    outputs bit-equal, 12 K1 launches per replay; three recorded steps
    (SGD momentum) give equal losses, gradients and running statistics
    within 1e-5 of max |value| (cuDNN deterministic)."""
    from mxnet_tpu_torch import gluon
    net = _narrow_resnet(cuda)
    eager = _twin(net, _narrow_resnet, cuda)
    net.hybridize()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x = torch.randn(16, 3, 32, 32, generator=gen, device=cuda)
    y = torch.randint(0, 10, (16,), generator=gen, device=cuda).float()
    with torch.inference_mode():
        want = eager(x)
        net(x)
        kernels.reset_launch_counts()
        got = net(x)
    assert kernels.launch_counts() == dict(_NONE, conv_epilogue=12)
    assert torch.equal(got, want)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    t_net = gluon.Trainer(net.collect_params(), "sgd", dict(sgd))
    t_eager = gluon.Trainer(eager.collect_params(), "sgd", dict(sgd))
    for _ in range(3):
        _close_rel(_step(net, x, y, loss_fn), _step(eager, x, y, loss_fn),
                   1e-5, "loss")
        _same_step(net, eager, 1e-5)
        t_net.step(16)
        t_eager.step(16)
    assert len(net._graphs) == 2          # one predict, one training program


def test_hybridized_bert_trains_as_eager_with_the_graphs_bits(cuda):
    """The narrow BERT MLM at S 1100 (K3 and its backward, K2 with
    dropout 0.1 drawn inside the graph): the predict outputs bit-equal to
    the eager ones; a graphed step recorded with a bits tape equals an
    eager step replaying those bits, loss and every gradient within 1e-5
    of max |value|; two replays draw different masks and reseeding
    reproduces them."""
    from mxnet_tpu_torch import gluon
    net = _narrow_bert(cuda, dropout=0.1, max_length=1100)
    eager = _twin(net, lambda d: _narrow_bert(d, 0.1, 1100), cuda)
    net.hybridize()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    x = torch.randint(0, 100, (2, 1100), generator=gen, device=cuda,
                      dtype=torch.int32)
    y = x.float()
    with torch.inference_mode():
        for got, want in zip(net(x), eager(x)):
            assert torch.equal(got, want)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    masks = []
    for seed in (7, 7, None):
        if seed is not None:
            trandom.seed(seed)
        with trandom.bits_tape() as tape:
            got = _step(net, x, y, loss_fn, pick=1)
        masks.append([b.clone() for b in tape.drawn])
    assert len(masks[0]) > 0
    assert all(torch.equal(a, b) for a, b in zip(masks[0], masks[1]))
    assert not all(torch.equal(a, b) for a, b in zip(masks[1], masks[2]))
    with trandom.bits_tape(replay=masks[2]):
        want = _step(eager, x, y, loss_fn, pick=1)
    _close_rel(got, want, 1e-5, "loss")
    _same_step(net, eager, 1e-5)
    with trandom.bits_tape(replay=masks[2]):
        with pytest.raises(MXNetError, match="replay"):
            net(x)


def test_hybridized_grad_req_add_accumulates_as_eager(cuda, deterministic):
    """grad_req "add" over two graphed steps: the parameters' .grad are
    not the graph's buffers (a replay would overwrite them), so they sum
    as eager ones."""
    from mxnet_tpu_torch import gluon
    net = _narrow_resnet(cuda)
    eager = _twin(net, _narrow_resnet, cuda)
    net.hybridize()
    for m in (net, eager):
        for p in m.collect_params().values():
            if p.requires_grad:
                p.grad_req = "add"
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        x = torch.randn(4, 3, 32, 32, generator=gen, device=cuda)
        y = torch.randint(0, 10, (4,), generator=gen, device=cuda).float()
        _step(net, x, y, loss_fn)
        _step(eager, x, y, loss_fn)
    _same_step(net, eager, 1e-5)


def test_hybridized_two_forwards_before_one_backward(cuda, deterministic):
    """Two calls at one key inside one record(), one backward: a second
    program takes the second call, and the gradients equal eager ones."""
    from mxnet_tpu_torch import gluon
    net = _narrow_resnet(cuda)
    eager = _twin(net, _narrow_resnet, cuda)
    net.hybridize()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    x1, x2 = (torch.randn(4, 3, 32, 32, generator=gen, device=cuda)
              for _ in range(2))
    y = torch.randint(0, 10, (4,), generator=gen, device=cuda).float()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for m in (net, eager):
        with tag.record():
            loss = loss_fn(m(x1), y) + 2 * loss_fn(m(x2), y)
        tag.backward(loss)
    assert len(net._graphs) == 2
    _same_step(net, eager, 1e-5)


def test_hybridized_reads_parameters_at_call_time(cuda):
    """load_dict into live parameters after the capture (in place) changes
    the graphed output to the eager one of the new weights, no capture;
    a rebound parameter makes the block capture anew."""
    net = _narrow_bert(cuda)
    other = _narrow_bert(cuda)
    with torch.no_grad():
        for t in other.collect_params().values():
            if t.requires_grad:
                t.add_(0.01)
    x = torch.randint(0, 100, (2, 12), device=cuda, dtype=torch.int32)
    net.hybridize()
    with torch.inference_mode():
        before = net(x)[0]
        net.load_dict({k: v.detach().cpu().numpy()
                       for k, v in other.collect_params().items()})
        after = net(x)[0]
        want = other(x)[0]
    assert net._graphs.captures == 1
    assert not torch.equal(before, after)
    assert torch.equal(after, want)
    net.word_embed.weight = torch.nn.Parameter(
        other.word_embed.weight.detach().clone() * 2)
    with torch.inference_mode():
        rebound = net(x)[0]
    assert net._graphs.captures == 2
    assert not torch.equal(rebound, after)


def test_server_serves_from_graphed_predictors(cuda):
    """The server on the card with aot_prewarm: one graph per batch
    bucket captured before traffic; each request, served alone at batch
    bucket 1, equals the eager forward of that sample at batch 1 (the
    same shape, so the same convolution algorithms) within 1e-6 of max
    |value|."""
    from mxnet_tpu_torch.serving import Server, ServerConfig
    net = _narrow_resnet(cuda)
    cfg = ServerConfig(max_batch=4, aot_prewarm=((3, 32, 32),))
    server = Server(net, cfg, ctx=cuda).start()
    try:
        warm = server.stats()["prewarm"]
        assert (warm["warmed"], warm["loaded"], warm["compiled"]) == (3, 0, 3)
        x = torch.randn(3, 3, 32, 32, device=cuda)
        got = [server.predict(x[i].cpu().numpy()) for i in range(3)]
    finally:
        server.stop()
    for i in range(3):
        with torch.inference_mode():
            want = net(x[i:i + 1])[0].cpu().numpy()
        assert abs(got[i] - want).max() <= 1e-6 * abs(want).max()


def _sharded(net, opt, params, dtype, eager=False):
    from mxnet_tpu_torch import gluon, parallel
    trainer = parallel.ShardedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=parallel.make_mesh({"data": 1, "model": 1}),
        compute_dtype=dtype)
    if eager:
        trainer._backend = None
    return trainer


_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def test_sharded_fp16_overflow_is_skipped_inside_the_graph(cuda):
    """The narrow ResNet V1 through ShardedTrainer in fp16: after two
    graphed steps, a step at loss scale 2^40 overflows; inside the graph
    the weights, the momentum and the BatchNorm running statistics stay
    bit-unchanged, the scale halves, the skip is counted, and no second
    program is captured."""
    net = _narrow_resnet(cuda)
    trainer = _sharded(net, "sgd", _SGD, "float16")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    x = torch.randn(16, 3, 32, 32, generator=gen, device=cuda)
    y = torch.randint(0, 10, (16,), generator=gen, device=cuda)
    for _ in range(2):
        trainer.step(x, y)
    before = {k: v.detach().clone() for k, v in net.collect_params().items()}
    states = [s.clone() for st in trainer._states for s in st]
    skipped = trainer.skipped_steps
    trainer._scaler.loss_scale = 2.0 ** 40
    trainer.step(x, y)
    torch.cuda.synchronize()
    assert trainer._scaler.loss_scale == 2.0 ** 39
    assert trainer.skipped_steps == skipped + 1
    assert len(trainer._programs) == 1
    for k, v in net.collect_params().items():
        assert torch.equal(v, before[k]), k
    for s, b in zip((s for st in trainer._states for s in st), states):
        assert torch.equal(s, b)


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_graphed_sharded_step_equals_eager(cuda, deterministic, model):
    """Three bf16 ShardedTrainer steps captured as one CUDA graph against
    an eager twin on the card from the same weights: the narrow ResNet V1
    (SGD momentum, cuDNN deterministic) and the narrow BERT MLM (Adam,
    dropout 0.1, the eager step replaying the graph's bits). Losses,
    outputs, weights, optimizer state and statistics within 1e-5 of max
    |value| (measured bit-equal in the graphs of hybridize)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import random as trandom
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    if model == "resnet":
        net = _narrow_resnet(cuda)
        twin = _twin(net, _narrow_resnet, cuda)
        opt, params = "sgd", _SGD
        x = torch.randn(16, 3, 32, 32, generator=gen, device=cuda)
        y = torch.randint(0, 10, (16,), generator=gen, device=cuda)
        wrap = lambda n: n                                   # noqa: E731
    else:
        def make(dev):
            return _narrow_bert(dev, dropout=0.1)
        net = make(cuda)
        twin = _twin(net, make, cuda)
        opt, params = "adam", {"learning_rate": 1e-3}
        x = torch.randint(0, 100, (4, 16), generator=gen, device=cuda,
                          dtype=torch.int32)
        y = x

        class MLM(gluon.HybridBlock):
            def __init__(self, inner):
                super().__init__()
                self.inner = inner

            def forward(self, tokens):
                return self.inner(tokens)[1]
        wrap = MLM
    graphed = _sharded(wrap(net), opt, params, "bfloat16")
    eager = _sharded(wrap(twin), opt, params, "bfloat16", eager=True)
    for _ in range(3):
        with trandom.bits_tape() as tape:
            gl = graphed.step(x, y)
        bits = [b.clone() for b in tape.drawn]
        with trandom.bits_tape(replay=bits):
            el = eager.step(x, y)
        _close_rel(gl, el, 1e-5, "loss")
        for g, e in zip(graphed.last_outputs, eager.last_outputs):
            _close_rel(g.float(), e.float(), 1e-5, "outputs")
    assert len(graphed._programs) == 1 and not eager._programs
    pa, pb = net.collect_params(), twin.collect_params()
    for k in pa:
        _close_rel(pa[k].float(), pb[k].float(), 1e-5, k)
    for sa, sb in zip(graphed._states, eager._states):
        for a, b in zip(sa, sb):
            _close_rel(a, b, 1e-5, "optimizer state")


@pytest.mark.parametrize("rebind", ["cast", "clone"])
def test_graphed_sharded_step_recaptures_after_a_rebind(cuda, deterministic,
                                                        rebind):
    """A graph reads the parameters at the addresses it captured. After
    the first bf16 graphed step of the narrow ResNet V1, the masters are
    cast to bf16 (``Block.cast``) or each rebound to a copy of itself;
    the next two graphed steps capture anew and equal an eager twin's
    within 1e-5 of max |value|, and the rebound parameters are the ones
    updated."""
    net = _narrow_resnet(cuda)
    twin = _twin(net, _narrow_resnet, cuda)
    graphed = _sharded(net, "sgd", _SGD, "bfloat16")
    eager = _sharded(twin, "sgd", _SGD, "bfloat16", eager=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    x = torch.randn(16, 3, 32, 32, generator=gen, device=cuda)
    y = torch.randint(0, 10, (16,), generator=gen, device=cuda)
    for step in range(3):
        if step == 1:
            for tr in (graphed, eager):
                if rebind == "cast":
                    tr._block.cast("bfloat16")
                else:
                    for p in tr._trainable:
                        p.data = p.data.clone()
            before = [p.detach().clone() for p in graphed._trainable]
            first = next(iter(graphed._programs.values()))
        _close_rel(graphed.step(x, y), eager.step(x, y), 1e-5, "loss")
    assert first.released and len(graphed._programs) == 1
    assert any(not torch.equal(p, b)
               for p, b in zip(graphed._trainable, before))
    pa, pb = net.collect_params(), twin.collect_params()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype, k
        _close_rel(pa[k].float(), pb[k].float(), 1e-5, k)
    for sa, sb in zip(graphed._states, eager._states):
        for a, b in zip(sa, sb):
            _close_rel(a, b, 1e-5, "optimizer state")


_FUNCTIONAL = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
               "nag": {"learning_rate": 0.1, "momentum": 0.9},
               "adam": {"learning_rate": 0.01},
               "adamw": {"learning_rate": 0.01},
               "lamb": {"learning_rate": 0.01},
               "rmsprop": {"learning_rate": 0.01},
               "adagrad": {"learning_rate": 0.1},
               "ftrl": {"learning_rate": 0.1},
               "signum": {"learning_rate": 0.01, "momentum": 0.9},
               "adadelta": {"rho": 0.9},
               "nadam": {"learning_rate": 0.01},
               "dcasgd": {"learning_rate": 0.1, "momentum": 0.9},
               "ftml": {"learning_rate": 0.01}}


def _mlp(cuda):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, in_units=16, activation="relu"),
            nn.Dense(8, in_units=32))
    net.initialize(tinit.Xavier(), ctx=cuda, generator=trandom.generator(0))
    return net


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", sorted(_FUNCTIONAL))
def test_graphed_functional_optimizer_step_equals_eager(cuda, name, dtype):
    """Each optimizer with a functional rule, a PolyScheduler, wd,
    clip_gradient and lr / wd multipliers: two ShardedTrainer steps of
    an MLP captured as one CUDA graph against two eager steps from the
    same weights, bit for bit in the losses, weights and state."""
    from mxnet_tpu_torch import gluon, lr_scheduler, optimizer, parallel
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    x = torch.randn(16, 16, generator=gen, device=cuda)
    y = torch.randn(16, 8, generator=gen, device=cuda)
    runs = []
    for graphed in (True, False):
        hyper = _FUNCTIONAL[name]
        opt = optimizer.create(
            name, **hyper, wd=1e-3, clip_gradient=0.1,
            lr_scheduler=lr_scheduler.PolyScheduler(
                max_update=10, pwr=1, warmup_steps=2,
                warmup_begin_lr=hyper.get("learning_rate", 1.0) / 4))
        opt.set_lr_mult({0: 2.0})
        opt.set_wd_mult({1: 0.0, 2: 2.0})
        trainer = parallel.ShardedTrainer(
            _mlp(cuda), gluon.loss.L2Loss(), opt,
            mesh=parallel.make_mesh({"data": 1, "model": 1}),
            compute_dtype=dtype)
        if not graphed:
            trainer._backend = None
        losses = [trainer.step(x, y) for _ in range(2)]
        runs.append(losses + list(trainer._trainable)
                    + [s for st in trainer._states for s in st])
        assert len(trainer._programs) == int(graphed)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_graphed_run_steps_equals_its_eager_loop(cuda):
    """The narrow BERT MLM through the LAMB recipe (PolyScheduler, wd
    multiplier 0 on biases and LayerNorms, GuardConfig(clip_norm=1)),
    dropout 0.1, bf16: two run_steps(3) windows, each one graph replay,
    against the eager window replaying the graph's dropout bits; the
    losses, weights and state within 1e-5 of max |value|, one program,
    and the graphed window bit-equal to three graphed step() calls at
    dropout 0."""
    from mxnet_tpu_torch import gluon, guardrails, lr_scheduler, optimizer
    from mxnet_tpu_torch import parallel

    class MLM(gluon.HybridBlock):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, tokens):
            return self.inner(tokens)[1]

    def trainer_of(net):
        opt = optimizer.create("lamb", learning_rate=1e-3, wd=0.01,
                               lr_scheduler=lr_scheduler.PolyScheduler(
                                   max_update=100, pwr=1, warmup_steps=4))
        names = [n for n, p in net.named_parameters() if p.requires_grad]
        opt.set_wd_mult({i: 0.0 for i, n in enumerate(names)
                         if n.endswith(("bias", "gamma", "beta"))})
        return parallel.ShardedTrainer(
            MLM(net), gluon.loss.SoftmaxCrossEntropyLoss(), opt,
            mesh=parallel.make_mesh({"data": 1, "model": 1}),
            compute_dtype="bfloat16",
            guard=guardrails.GuardConfig(clip_norm=1.0))

    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    x = torch.randint(0, 100, (4, 16), generator=gen, device=cuda,
                      dtype=torch.int32)

    def make(dev):
        return _narrow_bert(dev, dropout=0.1)

    net = make(cuda)
    graphed, eager = trainer_of(net), trainer_of(_twin(net, make, cuda))
    eager._backend = None
    for _ in range(2):
        with trandom.bits_tape() as tape:
            gl = graphed.run_steps(x, x, num_steps=3)
        bits = [b.clone() for b in tape.drawn]
        with trandom.bits_tape(replay=bits):
            el = eager.run_steps(x, x, num_steps=3)
        _close_rel(gl, el, 1e-5, "loss")
    assert len(graphed._programs) == 1 and not eager._programs
    for sa, sb in zip(graphed._trainable + [s for st in graphed._states
                                            for s in st],
                      eager._trainable + [s for st in eager._states
                                          for s in st]):
        _close_rel(sa.float(), sb.float(), 1e-5, "weights and state")

    net = _narrow_bert(cuda)
    window, steps = trainer_of(net), trainer_of(_twin(net, _narrow_bert,
                                                      cuda))
    last = window.run_steps(x, x, num_steps=3)
    losses = [steps.step(x, x) for _ in range(3)]
    assert torch.equal(last, losses[-1])
    for a, b in zip(window._trainable, steps._trainable):
        assert torch.equal(a, b)


def test_decode_programs_are_graphs_on_the_card(cuda):
    import numpy as np

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.serving import decode
    eng = decode.DecodeEngine(decode.TinyLM(),
                              decode.DecodeConfig(slots=4, window_ms=1.0),
                              ctx=tmx.gpu(0)).start()
    try:
        assert eng.warmup()["compiled"] == 7
        assert all(p.graph is not None for p in eng._programs.values())
        rng = np.random.RandomState(0)
        specs = [(rng.randint(0, 251, int(rng.randint(1, 200))).tolist(),
                  int(rng.randint(1, 56))) for _ in range(16)]
        streams = [eng.submit(p, max_new_tokens=n) for p, n in specs]
        assert [s.result(60) for s in streams] == \
            [eng.model.reference(p, n) for p, n in specs]
        assert eng.stats()["compiles"] == 7
    finally:
        eng.stop()
