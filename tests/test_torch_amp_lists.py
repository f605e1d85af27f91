"""``amp.init`` with op lists — the per-op cast policy — in the port
against the JAX package, on the CPU.

The same listed ops get the same input dtypes in both packages, through
``mx.nd`` (the registry's dispatch) and through Gluon blocks (whose op
calls pass ``_dispatch.amp_cast`` where the JAX blocks call ``F.<op>``):
values within bf16's rounding (1e-2 of max |value|: the two packages
round the same products to bf16 at different points), dtypes equal. An
unknown op name raises in both; ``reset`` and a re-``init`` without
lists drop the policy; a policy change bumps ``amp_epoch``, which the
hybridized block's graph cache keys on. The slice as a whole: the narrow
BERT MLM trained 3 Adam steps under ``target_precision_ops=
["FullyConnected", "Convolution"]`` (MXNet 1.x's bf16 list) in both
packages, each step's loss within 1e-2 relative."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu_torch import _dispatch
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp as tamp
from torch_parity import bert_pair, carry_block, jax_recorded_loss

CPU = tmx.cpu()
BF16_LIST = ["FullyConnected", "Convolution"]
TOL = 1e-2


@pytest.fixture
def policy():
    yield
    tamp.reset()
    jamp.reset()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return a.asnumpy().astype(np.float32)


def _dtype(a):
    return str(a.dtype).replace("torch.", "")


def test_op_lists_enforce_per_op_dtype_as_jax(policy):
    """tests/test_aux.py::test_amp_op_lists_enforce_per_op_dtype in both
    packages, dtypes and values compared."""
    lists = dict(target_precision_ops=["FullyConnected"], fp32_ops=["tanh"],
                 conditional_fp32_ops=[("Activation", "act_type",
                                        ["softsign"])])
    tamp.init("float16", **lists)
    jamp.init("float16", **lists)
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(2, 4).astype(np.float32),
               rng.randn(3, 4).astype(np.float32),
               rng.randn(3).astype(np.float32))
    h = rng.randn(2, 2).astype(np.float16)

    def run(mx, arr):
        out = [mx.nd.FullyConnected(arr(x), arr(w), arr(b), num_hidden=3)]
        hh = arr(h)
        out += [mx.nd.tanh(hh), mx.nd.Activation(hh, act_type="softsign"),
                mx.nd.Activation(hh, act_type="relu"), hh + hh,
                mx.nd.softmax(hh), mx.nd.sum(hh)]
        return out

    got = run(tmx, lambda a: tmx.nd.array(a, ctx=CPU))
    want = run(jmx, jmx.nd.array)
    assert [_dtype(g) for g in got] == [str(w.dtype) for w in want] == [
        "float16", "float32", "float32", "float16", "float16", "float32",
        "float32"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL)


def test_unknown_op_reset_and_reinit(policy):
    with pytest.raises(MXNetError, match="not registered"):
        tamp.init("float16", fp32_ops=["not_a_real_op_name"])
    with pytest.raises(Exception):
        jamp.init("float16", fp32_ops=["not_a_real_op_name"])
    tamp.reset()
    epoch = _dispatch.amp_epoch()
    tamp.init("bfloat16", target_precision_ops=["FullyConnected"])
    assert _dispatch.amp_epoch() == epoch + 1
    x = tmx.nd.ones((2, 4), ctx=CPU)
    w = tmx.nd.ones((3, 4), ctx=CPU)
    assert tmx.nd.FullyConnected(x, w, no_bias=True, num_hidden=3).dtype \
        == torch.bfloat16
    tamp.init("float16")                 # no lists: the policy goes
    assert tmx.nd.FullyConnected(x, w, no_bias=True, num_hidden=3).dtype \
        == np.float32
    assert tamp.amp_dtype() == "float16"
    tamp.init("float16", fp32_ops=["tanh"])
    tamp.reset()
    assert _dispatch._amp_cast_hook is None and tamp.amp_dtype() is None
    assert _dispatch.amp_epoch() == epoch + 4


def _layers(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=2),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.Flatten(), nn.Dense(6, activation="relu"),
            nn.Dense(5), nn.LayerNorm(in_channels=5))
    return net


def test_gluon_blocks_cast_as_jax(policy):
    """Conv2D, BatchNorm, Dense (the fused epilogue and the plain path),
    LayerNorm and a loss under the bf16 list: the port's dtypes at each
    layer are the JAX layers', values within bf16 rounding."""
    x = np.random.RandomState(1).randn(3, 2, 5, 5).astype(np.float32)
    label = np.float32([0, 3, 1])
    tnet, jnet = _layers(tmx), _layers(jmx)
    carry_block(jnet, tnet, [x])
    tamp.init("bfloat16", target_precision_ops=BF16_LIST)
    jamp.init("bfloat16", target_precision_ops=BF16_LIST)
    tl, jl = tmx.gluon.loss.SoftmaxCrossEntropyLoss(), \
        jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tout = [torch.from_numpy(x)]
    jout = [jmx.nd.array(x)]
    for tb, jb in zip(tnet, jnet):
        with torch.inference_mode():
            tout.append(tb(tout[-1]))
        jout.append(jb(jout[-1]))
    with torch.inference_mode():
        tloss = tl(tout[-2], torch.from_numpy(label))
    jloss = jl(jout[-2], jmx.nd.array(label))
    assert [_dtype(t) for t in tout[1:]] == [str(j.dtype)
                                             for j in jout[1:]]
    assert _dtype(tout[5]) == "bfloat16" and _dtype(tloss) == "float32"
    assert _dtype(tloss) == str(jloss.dtype)
    for t, j in zip(tout[1:] + [tloss], jout[1:] + [jloss]):
        w = _np(j)
        np.testing.assert_allclose(_np(t), w, rtol=0,
                                   atol=TOL * np.abs(w).max())


def test_policy_change_recaptures_hybridized_block(policy):
    """The graph cache keys on amp_epoch: a block hybridized before
    amp.init casts after it (the CPU runs the program eagerly)."""
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    net.hybridize()
    x = torch.ones(2, 4)
    assert net(x).dtype == torch.float32
    tamp.init("bfloat16", target_precision_ops=["FullyConnected"])
    assert net(x).dtype == torch.bfloat16
    tamp.reset()
    assert net(x).dtype == torch.float32


def test_bert_mlm_trains_under_the_bf16_list_as_jax(policy):
    """The slice: the narrow BERT MLM (2 layers, units 64) trained 3 Adam
    steps under the bf16 list in both packages; every Dense output bf16,
    the loss fp32, the weights fp32, each step's mean loss within 1e-2
    relative."""
    jnet, tnet, _ = bert_pair(dropout=0.0, use_pooler=False,
                              use_classifier=False)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 100, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 100, (2, 16)).astype(np.float32)
    tamp.init("bfloat16", target_precision_ops=BF16_LIST)
    jamp.init("bfloat16", target_precision_ops=BF16_LIST)
    jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    tamp.init_trainer(ttr)
    dense = []
    for m in tnet.modules():
        if isinstance(m, tmx.gluon.nn.Dense):
            m.register_forward_hook(lambda mod, i, o: dense.append(o.dtype))
    import jax.numpy as jnp
    for _ in range(3):
        jl = jax_recorded_loss(jnet, jloss, jnp.asarray(ids),
                               jnp.asarray(labels), output=1)
        with tmx.autograd.record():
            out = tnet(torch.from_numpy(ids))[1]
            tl = tloss(out, torch.from_numpy(labels))
        assert out.dtype == torch.bfloat16 and tl.dtype == torch.float32
        with tamp.scale_loss(tl, ttr) as scaled:
            tmx.autograd.backward(scaled)
        jtr.step(2)
        ttr.step(2)
        np.testing.assert_allclose(float(tl.detach().mean()),
                                   float(jl.mean()), rtol=TOL)
    assert set(dense) == {torch.bfloat16}
    assert {p.dtype for p in ttr._params} == {torch.float32}
