"""``ShardedTrainer.run_steps`` and the BERT pretraining recipe
(mxnet_tpu_torch/parallel/sharded.py) against the JAX package, on the
CPU, with a narrow BERT MLM (2 layers, 64 units, vocab 100, batch 4, S
24, the logits kept 3-D as examples/pretrain_bert.py's wrapper keeps
them).

The recipe: LAMB (lr 1e-3, wd 0.01), a ``PolyScheduler`` with a linear
warm-up, wd multiplier 0 on every bias, gamma and beta (by trainable
index through ``set_wd_mult``), ``GuardConfig(clip_norm=1.0)``.

- ``run_steps(4)`` against the JAX package's ``run_steps(4)`` at dropout
  0: the last loss within 1e-5 relative, every weight and optimizer
  state within 1e-5 of max |value| (measured 2.3e-6), the clip engaged
  (the first step's gradient norm above 1).
- In the port, ``run_steps(4)`` bit for bit equal to four ``step()``
  calls from the same state: losses, weights, optimizer state.
- On the CPU stand-in capture backend of tests/test_torch_hybridize.py,
  at dropout 0.1: the graphed windows equal to the eager ones bit for
  bit, one program per ``num_steps`` (``num_steps=1`` is ``step()``'s),
  the scalars written before each replay holding the scheduler's lr of
  each inner step.
- fp16: a window whose steps all overflow halves the loss scale once
  (one stale-scale run), and skips every step.
- A guarded step, a window and a guarded ``gluon.Trainer`` step each
  read their (loss, flag, norm) on the host with one copy, and the
  monitor gets the step's own values.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.guardrails.monitor import GuardConfig as JGuard
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.guardrails import GuardConfig

from test_torch_hybridize import Stub
from test_torch_sharded import (JaxMLM, PortMLM, _carry, _jax_state,
                                _port_state)
from torch_parity import bert_pair

VOCAB, BATCH, SEQ = 100, 4, 24
LAMB = {"learning_rate": 1e-3, "wd": 0.01}
NO_DECAY = (".bias", ".gamma", ".beta")


def _sched(pkg):
    return pkg.lr_scheduler.PolyScheduler(max_update=20, pwr=1,
                                          warmup_steps=3,
                                          warmup_begin_lr=1e-4)


def _recipe(pkg, model, mesh, guard, names):
    tr = pkg.parallel.ShardedTrainer(
        model, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), "lamb",
        dict(LAMB, lr_scheduler=_sched(pkg)), mesh=mesh, guard=guard)
    tr._optimizer.set_wd_mult({i: 0.0 for i, n in enumerate(names)
                               if n.endswith(NO_DECAY)})
    return tr


def _models(dropout=0.0):
    jnet, tnet, _ = bert_pair(seed=0, dropout=dropout, use_pooler=False,
                              use_classifier=False, vocab_size=VOCAB)
    ids = np.random.RandomState(1).randint(0, VOCAB, (BATCH, SEQ))
    return JaxMLM(jnet), PortMLM(tnet), (ids, ids)


def _port(model, backend=None):
    mesh = tpar.make_mesh({"data": 1, "model": 1}, devices=[tmx.cpu()])
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    tr = _recipe(tmx, model, mesh, GuardConfig(clip_norm=1.0), names)
    tr._backend = backend
    return tr


def test_run_steps_matches_jax():
    jmodel, tmodel, batch = _models()
    jtr = _recipe(jmx, jmodel, jpar.make_mesh(
        {"data": 1, "model": 1}, devices=jax.devices()[:1]),
        JGuard(clip_norm=1.0),
        [n for n, _ in tmodel.named_parameters()])
    ttr = _port(tmodel)
    for tr in (jtr, ttr):
        tr.prepare(batch[0])
    _carry(jtr, ttr)
    ids = torch.from_numpy(batch[0].astype(np.int32))
    _, grads, _ = ttr._loss_and_grads([ids], ids)
    assert float(tmx.guardrails.fused.guard_stats(grads)[1]) > 1.0
    jl = float(jtr.run_steps(*batch, num_steps=4).asnumpy())
    tl = float(ttr.run_steps(*batch, num_steps=4))
    assert tl == pytest.approx(jl, rel=1e-5)
    want, got = _jax_state(jtr), _port_state(ttr)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k] - w).max()) <= 1e-5 * scale, k
    assert ttr.num_update == jtr.num_update == 4
    assert ttr._hyper[0].count(0.0) == sum(
        n.endswith(NO_DECAY) for n, _ in ttr._named) > 0
    assert ttr._monitor.total_skips == 0


def test_run_steps_equals_steps_bit_for_bit():
    _, model, batch = _models()
    twin = copy.deepcopy(model)
    window, steps = _port(model), _port(twin)
    last = window.run_steps(*batch, num_steps=4)
    losses = [steps.step(*batch) for _ in range(4)]
    assert torch.equal(last, losses[-1])
    got, want = _port_state(window), _port_state(steps)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert window.num_update == steps.num_update == 4
    assert window._optimizer.num_update == 4


def test_graphed_window_on_the_stand_in_equals_eager():
    """Two windows of 2 and one of 1 (``step()``'s program) on the
    stand-in backend and eagerly, dropout 0.1, from one seed:
    bit-equal; a program per window length; the replayed scalars hold
    each inner step's lr."""
    _, model, batch = _models(dropout=0.1)
    graphed, eager = _port(model, Stub()), _port(copy.deepcopy(model))
    trandom.seed(3)
    gl = [graphed.run_steps(*batch, num_steps=n) for n in (2, 2, 1)]
    trandom.seed(3)
    el = [eager.run_steps(*batch, num_steps=n) for n in (2, 2, 1)]
    assert all(torch.equal(g, e) for g, e in zip(gl, el))
    got, want = _port_state(graphed), _port_state(eager)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(k[0] for k in graphed._programs) == [1, 2]
    assert len(graphed._backend.generators) == 2
    assert graphed.num_update == eager.num_update == 5
    sched = graphed._optimizer.lr_scheduler
    prog = next(p for k, p in graphed._programs.items() if k[0] == 2)
    lrs, (t, rescale, lscale) = prog.static_in[-1][:2], \
        prog.static_in[-1][2:].tolist()
    assert lrs.tolist() == [np.float32(sched(u)) for u in (3, 4)]
    assert (t, rescale, lscale) == (3.0, 1.0, 1.0)


def test_fp16_window_halves_the_scale_once_per_run():
    net = tmx.gluon.nn.Dense(3, in_units=4).initialize(
        ctx=tmx.cpu(), generator=trandom.generator(0))
    tr = tpar.ShardedTrainer(
        net, tmx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1},
        mesh=tpar.make_mesh({"data": 1}, devices=[tmx.cpu()]),
        compute_dtype="float16")
    x, y = np.ones((2, 4), np.float32), np.ones((2, 3), np.float32)
    tr.step(x, y)
    w = net.weight.detach().clone()
    tr._scaler.loss_scale = 2.0 ** 40
    tr.run_steps(x, y, num_steps=3)
    assert tr._scaler.loss_scale == 2.0 ** 39
    assert torch.equal(net.weight.detach(), w)
    assert tr.skipped_steps == 3 and tr.num_update == 4


def test_one_host_read_per_step_and_window(monkeypatch):
    from mxnet_tpu_torch.guardrails import fused as tfused
    fetch, calls = tfused.host_fetch, []

    def counted(*vals):
        calls.append(len(vals))
        return fetch(*vals)

    monkeypatch.setattr(tfused, "host_fetch", counted)
    net = tmx.gluon.nn.Dense(3, in_units=4).initialize(
        ctx=tmx.cpu(), generator=trandom.generator(0))
    x, y = np.ones((2, 4), np.float32), np.zeros((2, 3), np.float32)
    tr = tpar.ShardedTrainer(
        net, tmx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1},
        mesh=tpar.make_mesh({"data": 1}, devices=[tmx.cpu()]),
        guard=GuardConfig())
    loss = tr.step(x, y)
    assert calls == [1]
    last = tr.run_steps(x, y, num_steps=3)
    assert calls == [1, 1]
    seen = list(tr._monitor._losses)
    assert len(seen) == 4 and seen[0] == float(loss) and \
        seen[-1] == float(last)
    assert loss.ndim == last.ndim == 0
    calls.clear()
    params = net.collect_params()
    eager = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                              guard=GuardConfig())
    with tmx.autograd.record():
        out = tmx.gluon.loss.L2Loss()(net(torch.ones(2, 4)),
                                      torch.zeros(2, 3))
    tmx.autograd.backward(out)
    eager.step(2, loss=out)
    assert calls == [1]
