"""``nd.contrib.foreach``, ``while_loop`` and ``cond`` in the port
against the JAX package, on the CPU (tests/test_control_flow.py but its
symbolic tests, which tests/test_torch_symbol.py holds).

The same seeded inputs go through both packages: eagerly (the Python
loop, each step recorded) and inside a hybridized block (the JAX package
traces one ``lax.scan``; the port runs its program path: ``foreach``
unrolled, ``while_loop`` as ``max_iterations`` masked steps, ``cond``
predicated with ``where``, no host read of a device value). Outputs and
gradients within 1e-5 relative (1e-6 absolute) of the JAX package's,
the integer ones exact; the masked loop must equal the eager one."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import control_flow

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _close(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else \
        got.detach().numpy()
    want = want.asnumpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_foreach", [True, False])
def test_foreach_vs_unrolled_rnn_forward_and_grad(use_foreach):
    """An Elman cell scanned by foreach (and hand-unrolled): outputs and
    gradients as the JAX package's."""
    T, B, I, H = 5, 2, 3, 4
    x_np = _rand(T, B, I, seed=1, scale=0.5)
    wx_np = _rand(I, H, seed=2, scale=0.5)
    wh_np = _rand(H, H, seed=3, scale=0.5)

    def run(mx, arr):
        nd = mx.nd
        x, wx, wh = arr(x_np), arr(wx_np), arr(wh_np)
        wx.attach_grad()
        wh.attach_grad()
        h0 = arr(np.zeros((B, H), np.float32))

        def cell(xt, h):
            return nd.tanh(nd.dot(xt, wx) + nd.dot(h, wh))

        with mx.autograd.record():
            if use_foreach:
                outs, h_t = nd.contrib.foreach(
                    lambda xt, h: (cell(xt, h), cell(xt, h)), x, h0)
            else:
                h, steps = h0, []
                for t in range(T):
                    h = cell(x.slice_axis(axis=0, begin=t, end=t + 1)
                             .reshape(B, I), h)
                    steps.append(h)
                outs, h_t = nd.stack(*steps, axis=0), h
            loss = outs.sum() + h_t.sum()
        loss.backward()
        return outs, h_t, wx.grad, wh.grad

    got = run(tmx, lambda a: tmx.nd.array(a, ctx=CPU))
    want = run(jmx, jmx.nd.array)
    for g, w in zip(got, want):
        _close(g, w)


def test_foreach_multiple_data_and_states():
    xs_np, ys_np = _rand(4, 3, seed=4), _rand(4, 3, seed=5)

    def run(mx, arr):
        outs, states = mx.nd.contrib.foreach(
            lambda data, sts: ([data[0] + sts[0], data[1] * sts[1]],
                               [sts[0] + data[0], sts[1]]),
            [arr(xs_np), arr(ys_np)],
            [arr(np.zeros(3, np.float32)), arr(np.ones(3, np.float32))])
        return [*outs, *states]

    got = run(tmx, lambda a: tmx.nd.array(a, ctx=CPU))
    want = run(jmx, jmx.nd.array)
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g, w)


def test_foreach_inside_hybridized_block():
    """The hybridized block's foreach against the JAX package's traced
    one (one lax.scan), forward and the projection's gradient."""
    x_np = _rand(5, 2, 3, seed=6)

    class TScan(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.proj = tmx.gluon.nn.Dense(4, flatten=False, in_units=3)

        def forward(self, x):
            assert control_flow.program_path()
            h0 = torch.zeros(2, 4)
            outs, h_t = tmx.nd.contrib.foreach(
                lambda xt, h: (self.proj(xt) + h, self.proj(xt) + h), x, h0)
            return outs + h_t.reshape(1, 2, 4)

    class JScan(jmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.proj = jmx.gluon.nn.Dense(4, flatten=False, in_units=3)

        def hybrid_forward(self, F, x):
            h0 = F.zeros((2, 4))
            outs, h_t = F.contrib.foreach(
                lambda xt, h: (self.proj(xt) + h, self.proj(xt) + h), x, h0)
            return outs + h_t.reshape(1, 2, 4)

    tnet, jnet = TScan(), JScan()
    tnet.initialize(ctx=CPU)
    jnet.initialize()
    w = _rand(4, 3, seed=7)
    b = _rand(4, seed=8)
    jnet.proj.weight.set_data(jmx.nd.array(w))
    jnet.proj.bias.set_data(jmx.nd.array(b))
    with torch.no_grad():
        tnet.proj.weight.copy_(torch.from_numpy(w))
        tnet.proj.bias.copy_(torch.from_numpy(b))
    tnet.hybridize()
    jnet.hybridize()
    x_t, x_j = torch.from_numpy(x_np), jmx.nd.array(x_np)
    with jmx.autograd.record():
        jl = jnet(x_j).sum()
    jl.backward()
    with tmx.autograd.record():
        tout = tnet(x_t)
        tl = tout.sum()
    tmx.autograd.backward(tl)
    _close(tout, jnet(x_j))
    np.testing.assert_allclose(tnet.proj.weight.grad.numpy(),
                               jnet.proj.weight.grad().asnumpy(), rtol=RTOL,
                               atol=ATOL)


def _while_program(nd, i0, zeros):
    return nd.contrib.while_loop(
        lambda i, a: i < 4, lambda i, a: ([a + i], [i + 1, a + i * i]),
        [i0, zeros], max_iterations=6)


@pytest.mark.parametrize("case", ["semantics", "zero", "dtype"])
def test_while_loop_eager(case):
    def run(mx, arr):
        nd = mx.nd
        if case == "semantics":
            outs, (i_f, acc_f) = nd.contrib.while_loop(
                lambda i, a: i < 5, lambda i, a: ([i * 2], [i + 1, a + i]),
                [arr([0.0]), arr([0.0])], max_iterations=8)
            return [outs, i_f, acc_f]
        if case == "zero":
            outs, (i_f,) = nd.contrib.while_loop(
                lambda i: i < 0, lambda i: ([i * 3], [i + 1]),
                [arr([7.0])], max_iterations=4)
            return [outs, i_f]
        outs, _ = nd.contrib.while_loop(
            lambda i: i < 3, lambda i: ([i.astype("int32")], [i + 1]),
            [arr([0.0])], max_iterations=5)
        return [outs]

    got = run(tmx, lambda a: tmx.nd.array(np.float32(a), ctx=CPU))
    want = run(jmx, lambda a: jmx.nd.array(np.float32(a)))
    for g, w in zip(got, want):
        _close(g, w)
    if case == "semantics":
        assert got[0].shape == (8, 1)
        assert got[0].asnumpy()[:5, 0].tolist() == [0, 2, 4, 6, 8]


def test_while_loop_traced_matches_eager_and_jax():
    """Inside a hybridized block the masked loop (6 steps, the last two
    masked) equals the eager loop and the JAX package's lax.scan."""
    class TWL(tmx.gluon.HybridBlock):
        def forward(self, i0):
            outs, (i_f, a_f) = _while_program(tmx.nd, i0,
                                              torch.zeros(1))
            return outs, i_f, a_f

    class JWL(jmx.gluon.HybridBlock):
        def hybrid_forward(self, F, i0):
            outs, (i_f, a_f) = _while_program(F, i0, F.zeros((1,)))
            return outs, i_f, a_f

    tnet, jnet = TWL(), JWL()
    tnet.hybridize()
    jnet.hybridize()
    traced = tnet(torch.zeros(1))
    eager = _while_program(tmx.nd, tmx.nd.zeros((1,), ctx=CPU),
                           tmx.nd.zeros((1,), ctx=CPU))
    eager = [eager[0], *eager[1]]
    want = jnet(jmx.nd.array([0.0]))
    for t, e, w in zip(traced, eager, want):
        _close(t, w)
        _close(e, w)


def test_while_loop_needs_max_iterations_in_a_program():
    class NoMax(tmx.gluon.HybridBlock):
        def forward(self, i0):
            return tmx.nd.contrib.while_loop(
                lambda i: i < 3, lambda i: ([i], [i + 1]), [i0])[1]

    net = NoMax()
    net.hybridize()
    with pytest.raises(MXNetError, match="max_iterations"):
        net(torch.zeros(1))


def _beam(nd, trans, V=6, L=8, eos=0, **arr):
    def cond(step, toks, fin):
        return (step < L) * (fin.sum() < 1)

    def body(step, toks, fin):
        cur = nd.take(toks, step.astype("int32"), axis=0)
        logits = nd.take(trans, cur.astype("int32"), axis=0)
        nxt = logits.reshape(1, V).argmax(axis=-1)
        col = nd.one_hot(step.astype("int32") + 1, depth=L + 1)
        toks = (toks.reshape(1, L + 1) * (1 - col)
                + nd.broadcast_mul(nxt.reshape(1, 1), col)) \
            .reshape(L + 1).astype("int32")
        fin = nd.broadcast_maximum(fin, (nxt == eos).astype("float32"))
        return [], [step + 1, toks, fin]

    toks0 = nd.zeros((L + 1,), dtype="int32", **arr) + 2
    _, (steps, toks, fin) = nd.contrib.while_loop(
        cond, body, [nd.zeros((1,), **arr), toks0, nd.zeros((1,), **arr)],
        max_iterations=L)
    return steps, toks


def test_while_loop_beam_decode():
    """The greedy decode of tests/test_control_flow.py (an argmax chain
    with an EOS exit) in both packages and against a Python oracle."""
    trans_np = _rand(6, 6, seed=7)
    steps, toks = _beam(tmx.nd, tmx.nd.array(trans_np, ctx=CPU), ctx=CPU)
    jsteps, jtoks = _beam(jmx.nd, jmx.nd.array(trans_np))
    _close(toks, jtoks)
    _close(steps, jsteps)
    t = np.full((9,), 2, np.int64)
    s, f = 0, False
    while s < 8 and not f:
        nxt = trans_np[t[s]].argmax()
        t[s + 1] = nxt
        f = nxt == 0
        s += 1
    np.testing.assert_array_equal(toks.asnumpy(), t)
    assert int(steps.asnumpy()[0]) == s


def test_cond_eager_and_traced():
    a, b = np.float32([2.0]), np.float32([5.0])
    assert float(tmx.nd.contrib.cond(
        (tmx.nd.array(a, ctx=CPU) > tmx.nd.array(b, ctx=CPU)).reshape(()),
        lambda: tmx.nd.array(a, ctx=CPU),
        lambda: tmx.nd.array(b, ctx=CPU)).asnumpy()[0]) == 5.0

    class TCond(tmx.gluon.HybridBlock):
        def forward(self, x, y):
            return tmx.nd.contrib.cond((x.sum() > y.sum()).reshape(()),
                                       lambda: x * 2, lambda: y * 3)

    class JCond(jmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x, y):
            return F.contrib.cond((x.sum() > y.sum()).reshape(()),
                                  lambda: x * 2, lambda: y * 3)

    tnet, jnet = TCond(), JCond()
    tnet.hybridize()
    jnet.hybridize()
    for x in (a, np.float32([9.0])):
        _close(tnet(torch.from_numpy(x), torch.from_numpy(b)),
               jnet(jmx.nd.array(x), jmx.nd.array(b)))
