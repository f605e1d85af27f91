"""Training in the port (autograd scopes and backward, dropout's training
branch and its bits, the losses, the fused optimizer updates, Adam, SGD
and the Trainer) against the JAX package on the CPU, and the whole
training slice: a narrow BERT masked LM taking three Adam steps through
record -> SoftmaxCrossEntropyLoss -> backward -> Trainer.step in both
packages.

Inputs are seeded numpy arrays handed to both sides. Dropout parity goes
through explicit bits (the JAX package's own ``jax.random.bits`` of a
key, handed to the port), since the two packages' generators differ.
Tolerances are stated in each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops.nn import _dropout, _log_softmax
from mxnet_tpu.ops.optimizer_op import (_adam_update, _sgd_mom_update,
                                        _sgd_update)
from mxnet_tpu.ops.tensor import _logsumexp, _pick
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops import optimizer_op as topt
from mxnet_tpu_torch.ops import tensor as ttensor

from torch_parity import jax_recorded_loss


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "asnumpy"):
        return a.asnumpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# -- dropout -----------------------------------------------------------------
@pytest.mark.parametrize("axes", [(), (1,)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_with_explicit_bits_matches_jax(p, axes):
    """The port's training branch, given the bits the JAX op draws from
    its key, equals the JAX op (keep where bits >= keep_threshold(p),
    x / (1 - p)); float32 within 1e-6."""
    x = np.random.RandomState(1).randn(4, 6, 5).astype(np.float32)
    key = jax.random.key(3)
    shape = tuple(1 if a in axes else n for a, n in enumerate(x.shape))
    bits = np.array(jax.random.bits(key, shape, dtype=jnp.uint8))
    want = _dropout(jnp.asarray(x), rng=key, p=p, axes=axes, training=True)
    got = tops.dropout(torch.from_numpy(x), p=p, axes=axes, training=True,
                       bits=torch.from_numpy(bits))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    assert (_np(got) == 0).any()
    # mode="always" engages outside training too; predict is the identity
    x_t = torch.from_numpy(x)
    assert tops.dropout(x_t, p=p) is x_t
    always = tops.dropout(x_t, p=p, mode="always", axes=axes,
                          bits=torch.from_numpy(bits))
    np.testing.assert_allclose(_np(always), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_drawn_bits_keep_one_minus_p(p):
    """Bits drawn from a seeded generator: uint8, and the kept share of
    10^6 elements within 1% of 1 - p; kept values are x / (1 - p)."""
    gen = trandom.generator(7)
    x = torch.ones(1000, 1000)
    out = tops.dropout(x, p=p, training=True, generator=gen)
    kept = out != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) <= 0.01 * (1 - p)
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / (1 - p)))
    bits = trandom.bits((1000, 1000), "cpu", trandom.generator(7))
    assert bits.dtype == torch.uint8 and int(bits.max()) == 255


def test_seed_reseeds_every_device_generator():
    trandom.seed(11)
    a = trandom.bits((64,), "cpu")
    trandom.seed(11)
    assert torch.equal(a, trandom.bits((64,), "cpu"))
    assert not torch.equal(a, trandom.bits((64,), "cpu"))


def test_bits_tape_records_and_replays():
    x = torch.randn(3, 40)
    with trandom.bits_tape() as tape:
        first = tops.dropout(x, p=0.5, training=True)
        second = tops.dropout(x, p=0.5, training=True)
    assert len(tape.drawn) == 2
    with trandom.bits_tape(replay=tape.drawn):
        again = (tops.dropout(x, p=0.5, training=True),
                 tops.dropout(x, p=0.5, training=True))
    assert torch.equal(again[0], first) and torch.equal(again[1], second)


# -- autograd ----------------------------------------------------------------
SCOPES = {"record": (lambda ag: ag.record(), True, True),
          "record_predict": (lambda ag: ag.record(train_mode=False), True,
                             False),
          "record_then_predict_mode": (None, True, False)}


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_record_scopes_engage_dropout_as_jax(scope):
    """``record()`` engages dropout in every block, ``record(train_mode=
    False)`` and ``predict_mode()`` inside ``record()`` do not, in both
    packages; ``is_recording`` and ``is_training`` agree."""
    enter, recording, training = SCOPES[scope]
    x = np.ones((8, 50), np.float32)
    jdrop, tdrop = jnn.Dropout(0.5), tnn.Dropout(0.5)
    results = []
    for ag, drop, arr in ((jag, jdrop, jmx.nd.array(x)),
                          (tag, tdrop, torch.from_numpy(x))):
        if enter is None:
            with ag.record():
                with ag.predict_mode():
                    out = drop(arr)
                    flags = (ag.is_recording(), ag.is_training())
        else:
            with enter(ag):
                out = drop(arr)
                flags = (ag.is_recording(), ag.is_training())
        results.append((_np(out), flags))
    for out, flags in results:
        assert flags == (recording, training)
        if training:
            assert (out == 0).any() and np.isin(out, (0.0, 2.0)).all()
        else:
            np.testing.assert_array_equal(out, x)


def test_outside_scopes_blocks_keep_their_own_mode():
    x = torch.ones(4, 30)
    drop = tnn.Dropout(0.5)
    assert not drop.training and torch.equal(drop(x), x)
    drop.train()
    assert drop.training and (drop(x) == 0).any()
    with tag.pause():
        assert not drop.training and not torch.is_grad_enabled()
    drop.eval()
    with tag.train_mode():
        assert drop.training


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_grad_req_write_and_add_match_jax(grad_req):
    """Two backward passes without a step: ``write`` leaves the gradient
    of one, ``add`` the sum of both, as in the JAX package. Heads that
    are not scalars get ones as their head gradient."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jx = jmx.nd.array(x)
    jx.attach_grad(grad_req=grad_req)
    tx = torch.from_numpy(x).requires_grad_()
    tx.grad_req = grad_req
    for _ in range(2):
        with jag.record():
            jy = jx * jx + 1
        jy.backward()
        with tag.record():
            ty = tx * tx + 1
        tag.backward(ty)
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), rtol=0, atol=0)
    np.testing.assert_allclose(_np(tx.grad),
                               2 * x * (2 if grad_req == "add" else 1))


def test_backward_takes_head_grads_and_refuses_no_graph():
    tx = torch.ones(3, requires_grad=True)
    with tag.record():
        y = tx * 3
    tag.backward(y, torch.tensor([1.0, 2.0, 3.0]))
    torch.testing.assert_close(tx.grad, torch.tensor([3.0, 6.0, 9.0]))
    with pytest.raises(tmx.MXNetError, match="no recorded graph"):
        tag.backward(torch.ones(3))


# -- operators of the loss ---------------------------------------------------
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_logsumexp_pick_log_softmax_match_jax(axis, keepdims):
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 7, 5) * 4).astype(np.float32)
    idx = rng.randint(-2, 9, (3, 5) if axis == 1 else (3, 7))
    for got, want in (
            (ttensor.logsumexp(torch.from_numpy(x), axis, keepdims),
             _logsumexp(jnp.asarray(x), axis, keepdims)),
            (ttensor.pick(torch.from_numpy(x), torch.from_numpy(idx), axis,
                          keepdims),
             _pick(jnp.asarray(x), jnp.asarray(idx), axis, keepdims)),
            (ttensor.log_softmax(torch.from_numpy(x), axis),
             _log_softmax(jnp.asarray(x), axis))):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)


LOSSES = {
    "sparse": dict(),
    "smoothed": dict(label_smoothing=0.1),
    "from_logits": dict(from_logits=True),
    "dense": dict(sparse_label=False),
    "weighted_axis1": dict(axis=1, weight=0.5),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_softmax_ce_loss_values_and_grads_match_jax(name):
    """Per-sample loss and the gradient of its sum w.r.t. the scores, on
    (4, 6, 11) scores; float32 within 1e-5 of max |value|."""
    kwargs = LOSSES[name]
    rng = np.random.RandomState(len(name))
    pred = (rng.randn(4, 6, 11) * 3).astype(np.float32)
    if kwargs.get("from_logits"):
        pred = np.asarray(jax.nn.log_softmax(pred, axis=-1))
    if kwargs.get("sparse_label") is False:
        label = np.array(jax.nn.softmax(rng.randn(4, 6, 11), axis=-1),
                         np.float32)
    elif kwargs.get("axis") == 1:
        label = rng.randint(0, 6, (4, 11)).astype(np.float32)
    else:
        label = rng.randint(0, 11, (4, 6)).astype(np.float32)
    jp = jmx.nd.array(pred)
    jp.attach_grad()
    with jag.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss(**kwargs)(
            jp, jmx.nd.array(label))
    jl.backward()
    tp = torch.from_numpy(pred).requires_grad_()
    tl = tmx.gluon.loss.SoftmaxCrossEntropyLoss(**kwargs)(
        tp, torch.from_numpy(label))
    tag.backward(tl)
    assert tuple(tl.shape) == (4,)
    for got, want in ((tl, jl), (tp.grad, jp.grad)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_l2_loss_matches_jax():
    rng = np.random.RandomState(4)
    pred = rng.randn(5, 3).astype(np.float32)
    label = rng.randn(5, 3).astype(np.float32)
    want = jgluon.loss.L2Loss()(jmx.nd.array(pred), jmx.nd.array(label))
    got = tmx.gluon.loss.L2Loss()(torch.from_numpy(pred),
                                  torch.from_numpy(label))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)


# -- optimizer updates -------------------------------------------------------
def _state(seed, n=50):
    rng = np.random.RandomState(seed)
    return [rng.randn(n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("kw", [dict(), dict(wd=0.01, rescale_grad=0.25),
                                dict(clip_gradient=0.5, wd=0.1)])
def test_fused_updates_match_jax(kw):
    """adam_update, sgd_mom_update and sgd_update write what the JAX ops
    return, float32 within 1e-6."""
    w, g, m = _state(5)
    var = np.abs(m) * 0.1
    tw, tm, tv = (torch.from_numpy(a.copy()) for a in (w, m, var))
    topt.adam_update(tw, torch.from_numpy(g), tm, tv, lr=0.01, **kw)
    jw, jm, jv = _adam_update(*(jnp.asarray(a) for a in (w, g, m, var)),
                              lr=0.01, **kw)
    for got, want in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    topt.sgd_mom_update(tw, torch.from_numpy(g), tm, lr=0.1, momentum=0.9,
                        **kw)
    jw, jm = _sgd_mom_update(*(jnp.asarray(a) for a in (w, g, m)), lr=0.1,
                             momentum=0.9, **kw)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-6, atol=1e-6)
    tw = torch.from_numpy(w.copy())
    topt.sgd_update(tw, torch.from_numpy(g), lr=0.1, **kw)
    np.testing.assert_allclose(
        _np(tw), _np(_sgd_update(jnp.asarray(w), jnp.asarray(g), lr=0.1,
                                 **kw)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("adam", dict(learning_rate=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_gradient=1.0)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.1))])
def test_optimizer_three_steps_match_jax(name, kwargs):
    """The Optimizer classes (Adam with its bias correction folded into
    lr) over 3 steps fed identical gradients, float32 within 1e-6."""
    grads = [_state(10 + t)[0] for t in range(3)]
    w0 = _state(9)[1]
    jo = jmx.optimizer.create(name, **kwargs)
    to = tmx.optimizer.create(name, **kwargs)
    jw, tw = jmx.nd.array(w0), torch.from_numpy(w0.copy())
    jstate, tstate = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, jmx.nd.array(g), jstate)
        to.update(0, tw, torch.from_numpy(g), tstate)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=1e-6, atol=1e-6)
    assert to._index_update_count == {0: 3}


def test_trainer_rescales_and_updates_unreached_weights_with_zero():
    """``step(batch_size)`` divides the gradient by the batch; a weight
    that no backward reached moves as with a zero gradient (not at all
    under Adam); buffers are not trained."""
    dense = tnn.Dense(3, in_units=4).initialize(ctx=tmx.cpu(),
                                                generator=trandom.generator(0))
    unused = torch.nn.Parameter(torch.ones(2))
    buf = torch.zeros(2)
    params = dict(dense.collect_params(), unused=unused, buf=buf)
    trainer = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    w0 = dense.weight.detach().clone()
    x = torch.ones(2, 4)
    with tag.record():
        loss = dense(x).sum(dim=1)
    tag.backward(loss)
    grad = dense.weight.grad.clone()
    trainer.step(2)
    torch.testing.assert_close(dense.weight.detach(), w0 - 0.5 * grad / 2)
    assert torch.equal(unused.detach(), torch.ones(2))
    assert len(trainer._params) == 3 and trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.1)
    assert trainer.learning_rate == 0.1


# -- the whole slice ---------------------------------------------------------
MLM = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
           max_length=1100, vocab_size=50, dropout=0.0, use_pooler=False,
           use_classifier=False)
MLM_BATCH, MLM_SEQ = 2, 1100


def _mlm_pair(seed=0):
    """The narrow BERT MLM in both packages, seeded weights carried into
    the port on the CPU."""
    jnet = jbert.BERTModel(**MLM)
    jnet.initialize(jmx.init.Normal(0.02), ctx=jmx.cpu())
    jnet(jmx.nd.array(np.zeros((1, 2), np.int32), dtype="int32"))
    rng = np.random.RandomState(seed)
    params = jnet._structural_names()
    for name in sorted(params):
        shape = params[name].shape
        value = 1.0 + 0.1 * rng.randn(*shape) if name.endswith("gamma") \
            else (0.05 if name.endswith("weight") else 0.02) \
            * rng.randn(*shape)
        params[name].set_data(jmx.nd.array(value.astype(np.float32)))
    tnet = tbert.BERTModel(**MLM)
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in params.items()}, ctx=tmx.cpu())
    return jnet, tnet


def test_bert_mlm_trains_as_the_jax_package(monkeypatch):
    """Three steps of record -> SoftmaxCrossEntropyLoss over every
    position -> backward -> Trainer("adam", lr 1e-3).step(B) in both
    packages, S 1100 so attention takes the flash path's Function. Every
    parameter's step-1 gradient within 1e-4 of its max |value|; the
    per-sample losses of steps 1-3 within 1e-5 relative. (Adam-updated
    weights are not compared element by element: Adam turns
    rounding-level gradient differences near its epsilon into lr-sized
    ones; the losses of steps 2 and 3 see the updates.)"""
    flash_calls = []
    inner = tcontrib.flash_attention_qkv
    monkeypatch.setattr(tcontrib, "flash_attention_qkv",
                        lambda *a, **k: flash_calls.append(1)
                        or inner(*a, **k))
    jnet, tnet = _mlm_pair()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, MLM["vocab_size"], (MLM_BATCH, MLM_SEQ))
    labels = rng.randint(0, MLM["vocab_size"], (MLM_BATCH, MLM_SEQ))
    jx = jmx.nd.array(ids.astype(np.int32), dtype="int32")
    jy = jmx.nd.array(labels.astype(np.float32))
    tx = torch.from_numpy(ids.astype(np.int32))
    ty = torch.from_numpy(labels.astype(np.float32))
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = jgluon.Trainer(jnet.collect_params(), "adam",
                              {"learning_rate": 1e-3})
    ttrainer = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                                 {"learning_rate": 1e-3})
    kernels.reset_launch_counts()
    for step in range(3):
        # the JAX package's record() -> loss -> backward, one jitted program
        jl = jax_recorded_loss(jnet, jloss, jx._data, jy._data, output=1)
        with tag.record():
            mlm = tnet(tx)[1]
            tl = tloss(mlm, ty)
        assert tuple(mlm.shape) == (MLM_BATCH, MLM_SEQ, MLM["vocab_size"])
        tag.backward(tl)
        if step == 0:
            jgrads = {k: p.grad().asnumpy()
                      for k, p in jnet._structural_names().items()
                      if k != "position_embed"}
            tparams = tnet.collect_params()
            assert set(tparams) == set(jgrads)
            for name, want in jgrads.items():
                got = tparams[name].grad
                got = np.zeros_like(want) if got is None else _np(got)
                scale = np.abs(want).max()
                assert np.abs(got - want).max() <= 1e-4 * scale, name
        jtrainer.step(MLM_BATCH)
        ttrainer.step(MLM_BATCH)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=0)
    assert len(flash_calls) == 3 * MLM["num_layers"]
    assert not any(kernels.launch_counts().values())      # CPU path
