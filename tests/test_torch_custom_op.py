"""``mx.operator`` custom operators in the port against the JAX package,
on the CPU (tests/test_custom_op.py): the user's numpy forward and
backward run on host copies of the inputs, wired into autograd; results
and gradients within 1e-6 relative of the JAX package's host callbacks
(1e-5 of max |value| where a tanh follows the op: the two packages round
tanh's derivative differently). Inside a CUDA-graph capture ``Custom``
raises (the card test is phase 29 (d) of chip_smoke.py); here the
capture check is exercised by a stand-in that reports a capture."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import operator as jop
from mxnet_tpu_torch import operator as top
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()


def _prop(mod):
    class ScaledSquareProp(mod.CustomOpProp):
        def __init__(self, scale=1.0):
            super().__init__(need_top_grad=True)
            self._scale = float(scale)

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self._scale

            class Op(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                scale * in_data[0] ** 2)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2.0 * scale * in_data[0] * out_grad[0])
            return Op()
    return ScaledSquareProp


def _two_out(mod):
    class SumDiffProp(mod.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] + in_data[1])
                    self.assign(out_data[1], req[1], in_data[0] - in_data[1])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] + out_grad[1])
                    self.assign(in_grad[1], req[1],
                                out_grad[0] - out_grad[1])
            return Op()
    return SumDiffProp


top.register("t_scaled_square")(_prop(top))
jop.register("t_scaled_square")(_prop(jop))
top.register("t_sum_diff")(_two_out(top))
jop.register("t_sum_diff")(_two_out(jop))


def _run(mx, arr, x_np, chain):
    x = arr(x_np)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="t_scaled_square", scale=3.0)
        out = mx.nd.tanh(y) if chain else y
        loss = out.sum()
    loss.backward()
    return out.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("chain", [False, True])
def test_custom_forward_backward_as_jax(chain):
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    got = _run(tmx, lambda a: tmx.nd.array(a, ctx=CPU), x, chain)
    want = _run(jmx, jmx.nd.array, x, chain)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-5 * np.abs(w).max() if chain
                                   else 1e-7)


def test_custom_two_inputs_as_jax():
    """Two inputs through one custom op; the first output as the
    registry returns it (one output declared), its gradient to both."""
    rng = np.random.RandomState(1)
    a_np, b_np = rng.randn(2, 3).astype(np.float32), \
        rng.randn(2, 3).astype(np.float32)
    res = []
    for mx, arr in ((tmx, lambda v: tmx.nd.array(v, ctx=CPU)),
                    (jmx, jmx.nd.array)):
        a, b = arr(a_np), arr(b_np)
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            out = mx.nd.Custom(a, b, op_type="t_sum_diff")
            loss = (out * out).sum()
        loss.backward()
        res.append([out.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()])
    for g, w in zip(*res):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_custom_unregistered_raises():
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx=CPU), op_type="no_such_op")
    assert "Custom" not in tmx.ops.registry.DEFERRED


def test_custom_refuses_a_capture(monkeypatch):
    monkeypatch.setattr(top, "stream_capturing", lambda: True)
    with pytest.raises(MXNetError, match="t_scaled_square.*capture"):
        tmx.nd.Custom(tmx.nd.ones((2,), ctx=CPU), op_type="t_scaled_square")
