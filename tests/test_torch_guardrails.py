"""The port's guardrails (mxnet_tpu_torch/guardrails/, diagnostics/journal.py)
against the JAX package's, on the CPU.

- ``AnomalyMonitor``: the same flag and loss sequences give the same
  verdicts and the same journal records (every field but ``ts`` and
  ``up_s``), per step and through ``observe_window`` with and without
  ``collapse_runs``; ``GuardConfig`` takes its defaults from the same
  ``MXNET_TPU_GUARD_*`` variables.
- ``guard_report`` of a journal the port wrote equals the JAX package's
  report of the same file.
- ``clip_norm``: two guarded steps of a two-layer MLP, SGD with
  momentum, through ``ShardedTrainer`` and through ``gluon.Trainer``:
  losses within 1e-5 relative and weights within 1e-5 of max |value|
  of the JAX package's, with the clip engaged (the gradient norm well
  above it).
- A non-finite batch through a guarded ``ShardedTrainer`` and a guarded
  ``gluon.Trainer``: weights, optimizer state and BatchNorm statistics
  bit-unchanged, the ``nonfinite_grad`` records equal to the JAX
  package's, and ``TrainingDiverged`` at ``max_consecutive_skips``, in
  both packages.
- ``mode="deferred"``: no journal record per step, ``guard_poll``'s
  counts; refused by ``gluon.Trainer`` and with an fp16 scaler, as in
  the reference; ``GuardConfig(ckpt_root=)`` and ``gluon.Trainer``'s
  checkpoint methods accepted (the rollback itself:
  tests/test_torch_checkpoint.py).
"""
import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu.diagnostics import journal as jjournal
from mxnet_tpu.guardrails import monitor as jmon
from mxnet_tpu.guardrails.report import guard_report as jreport
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.diagnostics import journal as tjournal
from mxnet_tpu_torch.guardrails import monitor as tmon
from mxnet_tpu_torch.guardrails.report import guard_report as treport

BATCH = 8
FLAGS = [True, True, False, False, True, False, True, True, True, True,
         True, True, True, True, True, False, False, False]
LOSSES = [1.0, 1.1, 9.0, float("nan"), 0.9, 1.2, 1.0, 0.95, 1.05, 1.0,
          1.1, 30.0, 31.0, 1.0, 40.0, 1.0, 2.0, 3.0]


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("ts", "up_s")}
            for r in recs]


def _monitors(tmp_path, name, **cfg):
    out = []
    for pkg, mon, jr in (("jax", jmon, jjournal), ("port", tmon, tjournal)):
        path = tmp_path / f"{name}-{pkg}.jsonl"
        out.append((mon.AnomalyMonitor(
            mon.GuardConfig(**cfg), journal=jr.Journal(str(path)),
            consumer="test"), path))
    return out


@pytest.mark.parametrize("how", ["step", "window", "collapse"])
def test_monitor_verdicts_and_records_match_jax(tmp_path, how):
    """One sequence of flags and losses (skips, a NaN loss, a sustained
    spike) through both monitors: per step, as two windows, and as two
    windows with fp16's stale-scale runs collapsed."""
    cfg = dict(max_consecutive_skips=3, spike_factor=5.0, spike_window=8,
               spike_steps=2)
    verdicts = []
    for mon, _ in _monitors(tmp_path, how, **cfg):
        got = []
        if how == "step":
            for i, (f, loss) in enumerate(zip(FLAGS, LOSSES)):
                got.append(mon.observe(i + 1, f, loss=loss,
                                       grad_norm=0.5 * i))
        else:
            for lo, hi in ((0, 9), (9, 18)):
                got.append(mon.observe_window(
                    lo + 1, FLAGS[lo:hi], losses=LOSSES[lo:hi],
                    norms=[0.5 * i for i in range(lo, hi)],
                    collapse_runs=how == "collapse"))
        verdicts.append((got, mon.total_skips, mon.consecutive_skips,
                         mon.reason))
    assert verdicts[0] == verdicts[1]
    assert "diverged" in str(verdicts[1][0])
    (_, jpath), (_, tpath) = _monitors(tmp_path, how, **cfg)
    assert _records(tpath) == _records(jpath)
    assert {r["kind"] for r in _records(tpath)} >= {"nonfinite_grad",
                                                    "loss_spike"}


def test_guard_config_and_report_match_jax(tmp_path, monkeypatch):
    """The ``MXNET_TPU_GUARD_*`` defaults, ``coerce``, and
    ``guard_report`` of one journal the port wrote (skips from two
    consumers, a spike, a ``TrainingDiverged`` crash, a torn line)."""
    monkeypatch.setenv("MXNET_TPU_GUARD_MAX_SKIPS", "7")
    monkeypatch.setenv("MXNET_TPU_GUARD_SPIKE_FACTOR", "3.5")
    monkeypatch.setenv("MXNET_TPU_GUARD_WINDOW", "not a number")
    for attr in ("max_consecutive_skips", "spike_factor", "spike_window",
                 "spike_steps", "lr_backoff", "max_rollbacks", "clip_norm",
                 "mode", "ckpt_root"):
        assert getattr(tmon.GuardConfig(), attr) == \
            getattr(jmon.GuardConfig(), attr), attr
    assert tmon.GuardConfig.coerce(False) is None
    assert tmon.GuardConfig.coerce(True).max_consecutive_skips == 7
    with pytest.raises(MXNetError, match="guard must be"):
        tmon.GuardConfig.coerce("yes")
    with pytest.raises(MXNetError, match="mode"):
        tmon.GuardConfig(mode="later")

    path = tmp_path / "journal.jsonl"
    journal = tjournal.Journal(str(path))
    mon = tmon.AnomalyMonitor(tmon.GuardConfig(max_consecutive_skips=2),
                              journal=journal, consumer="sharded_trainer")
    with pytest.raises(tmon.TrainingDiverged) as err:
        with journal.phase("train"):
            for step in range(1, 4):
                if mon.observe(step, False, loss=1.0) == "diverged":
                    tmon.handle_divergence(mon, step, restore_fn=None,
                                           optimizer=None)
    assert err.value.step == 2 and err.value.consecutive_skips == 2
    journal.event("nonfinite_grad", step=9, consecutive=1,
                  consumer="gluon_trainer")
    journal.event("loss_spike", step=10, loss=5.0)
    journal.close()
    with open(path, "a") as f:
        f.write('{"kind": "nonfinite_gr')
    want, got = jreport(str(path)), treport(str(path))
    assert got == want
    assert got["skipped_steps"] == 3 and len(got["diverged_errors"]) == 1
    assert treport(str(tmp_path / "missing")) == jreport(
        str(tmp_path / "missing"))


# -- the trainers --------------------------------------------------------------
def _pair(batchnorm=False):
    """A two-layer MLP (with a BatchNorm between the layers) in both
    packages with one set of weights, and one batch."""
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(8, in_units=6, activation="relu"))
        if batchnorm:
            net.add(pkg.gluon.nn.BatchNorm(in_channels=8))
        net.add(pkg.gluon.nn.Dense(4, in_units=8))
        return net

    jnet, tnet = build(jmx), build(tmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    rng = np.random.RandomState(4)
    arrays = {k: (rng.rand(*p.shape) + 0.5 if k.endswith("var")
                  else 0.5 * rng.randn(*p.shape)).astype(np.float32)
              for k, p in jnet._structural_names().items()}
    for k, p in jnet._structural_names().items():
        p.set_data(jmx.nd.array(arrays[k]))
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    x = (3 * rng.randn(BATCH, 6)).astype(np.float32)
    y = (3 * rng.randn(BATCH, 4)).astype(np.float32)
    return jnet, tnet, x, y


SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}


def _jax_mesh():
    return jpar.make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])


def _port_mesh():
    return tpar.make_mesh({"data": 1, "model": 1}, devices=[tmx.cpu()])


def _weights(jnet, tnet):
    return ({k: p.data().asnumpy() for k, p in
             jnet._structural_names().items()},
            {k: v.detach().numpy().copy() for k, v in
             tnet.collect_params().items()})


def _close(got, want, what):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k] - w).max()) <= 1e-5 * scale, (what, k)


def test_clip_norm_matches_jax():
    """``GuardConfig(clip_norm=0.05)`` through both trainers: the
    global norm, from the guard's own reduction, is folded into the
    rescale (``ShardedTrainer``) or scales the gradients (``Trainer``),
    as in the JAX package."""
    guard = dict(clip_norm=0.05)
    jnet, tnet, x, y = _pair()
    jtr = jpar.ShardedTrainer(jnet, jgluon.loss.L2Loss(), "sgd", dict(SGD),
                              mesh=_jax_mesh(),
                              guard=jmon.GuardConfig(**guard))
    ttr = tpar.ShardedTrainer(tnet, tmx.gluon.loss.L2Loss(), "sgd",
                              dict(SGD), mesh=_port_mesh(),
                              guard=tmon.GuardConfig(**guard))
    for step in range(2):
        jl = float(jtr.step(x, y).asnumpy())
        tl = float(ttr.step(x, y))
        assert tl == pytest.approx(jl, rel=1e-5)
        want, got = _weights(jnet, tnet)
        _close(got, want, f"sharded step {step}")
    assert ttr._monitor.total_skips == 0

    jnet, tnet, x, y = _pair()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD),
                         guard=jmon.GuardConfig(**guard))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD),
                            guard=tmon.GuardConfig(**guard))
    jloss, tloss = jgluon.loss.L2Loss(), tmx.gluon.loss.L2Loss()
    for step in range(2):
        with jmx.autograd.record():
            jl = jloss(jnet(jmx.nd.array(x)), jmx.nd.array(y))
        jl.backward()
        norm = float(np.sqrt(sum(float((p.grad().asnumpy() ** 2).sum())
                                 for p in jnet.collect_params().values())))
        assert norm / BATCH > 10 * guard["clip_norm"]
        jtr.step(BATCH, loss=jl)
        with tmx.autograd.record():
            tl = tloss(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        tmx.autograd.backward(tl)
        ttr.step(BATCH, loss=tl)
        want, got = _weights(jnet, tnet)
        _close(got, want, f"gluon step {step}")


def _nonfinite_records(tmp_path, name, run, journal_mod):
    path = tmp_path / f"{name}.jsonl"
    journal_mod.reset_journal(str(path))
    try:
        with pytest.raises(Exception) as err:
            run()
    finally:
        journal_mod.reset_journal("off")
    recs = [r for r in _records(path) if r["kind"] == "nonfinite_grad"]
    for r in recs:
        r.pop("phase")
    return type(err.value).__name__, recs


def test_nonfinite_batches_skip_journal_and_diverge(tmp_path):
    """Guarded steps fed a batch with an Inf: every weight, optimizer
    state and BatchNorm statistic bit-unchanged, one ``nonfinite_grad``
    record per step equal to the JAX package's, and TrainingDiverged at
    the second (``max_consecutive_skips=2``), in both trainers of both
    packages."""
    guard = dict(max_consecutive_skips=2)
    jnet, tnet, x, y = _pair(batchnorm=True)
    bad = x.copy()
    bad[0, 0] = np.inf
    jtr = jpar.ShardedTrainer(jnet, jgluon.loss.L2Loss(), "sgd", dict(SGD),
                              mesh=_jax_mesh(),
                              guard=jmon.GuardConfig(**guard))
    ttr = tpar.ShardedTrainer(tnet, tmx.gluon.loss.L2Loss(), "sgd",
                              dict(SGD), mesh=_port_mesh(),
                              guard=tmon.GuardConfig(**guard))
    jtr.step(x, y)
    ttr.step(x, y)
    before = [t.detach().clone() for t in
              list(tnet.parameters()) + list(tnet.buffers())
              + [s for st in ttr._states for s in st]]

    def run(tr):
        def go():
            for _ in range(3):
                tr.step(bad, y)
        return go

    jerr, jrecs = _nonfinite_records(tmp_path, "jax-sharded", run(jtr),
                                     jjournal)
    terr, trecs = _nonfinite_records(tmp_path, "port-sharded", run(ttr),
                                     tjournal)
    assert terr == jerr == "TrainingDiverged"
    assert trecs == jrecs and len(trecs) == 2
    after = list(tnet.parameters()) + list(tnet.buffers()) \
        + [s for st in ttr._states for s in st]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert ttr.skipped_steps == 2 and ttr.num_update == 3

    jnet, tnet, x, y = _pair()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD),
                         guard=jmon.GuardConfig(**guard))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD),
                            guard=tmon.GuardConfig(**guard))
    jloss, tloss = jgluon.loss.L2Loss(), tmx.gluon.loss.L2Loss()

    def jrun():
        for _ in range(3):
            with jmx.autograd.record():
                jl = jloss(jnet(jmx.nd.array(bad)), jmx.nd.array(y))
            jl.backward()
            jtr.step(BATCH, loss=jl)

    def trun():
        for _ in range(3):
            with tmx.autograd.record():
                tl = tloss(tnet(torch.from_numpy(bad)), torch.from_numpy(y))
            tmx.autograd.backward(tl)
            ttr.step(BATCH, loss=tl)

    before = [p.detach().clone() for p in tnet.parameters()]
    jerr, jrecs = _nonfinite_records(tmp_path, "jax-gluon", jrun, jjournal)
    terr, trecs = _nonfinite_records(tmp_path, "port-gluon", trun, tjournal)
    assert terr == jerr == "TrainingDiverged"
    assert trecs == jrecs and len(trecs) == 2
    assert all(torch.equal(a, b) for a, b in zip(tnet.parameters(), before))
    assert ttr.skipped_steps == 2


def test_deferred_mode_and_refusals(tmp_path):
    """Deferred mode journals nothing per step and ``guard_poll`` reads
    the in-step counters; the reference's refusals hold; a guard with a
    ``ckpt_root`` and the checkpoint family of ``gluon.Trainer`` work."""
    _, tnet, x, y = _pair()
    bad = x.copy()
    bad[1, 2] = np.nan
    path = tmp_path / "deferred.jsonl"
    tjournal.reset_journal(str(path))
    try:
        tr = tpar.ShardedTrainer(tnet, tmx.gluon.loss.L2Loss(), "adam",
                                 mesh=_port_mesh(),
                                 guard=tmon.GuardConfig(mode="deferred"))
        for batch in (bad, bad, x, bad):
            tr.step(batch, y)
        assert not path.read_text()
        assert tr.guard_poll() == (3, 1)
    finally:
        tjournal.reset_journal("off")
    assert [r["kind"] for r in _records(path)] == ["guard_poll"]
    assert tr.skipped_steps == 3

    with pytest.raises(MXNetError, match="needs a fused trainer"):
        tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                          guard=tmon.GuardConfig(mode="deferred"))
    root = str(tmp_path / "ckpt")
    trainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                                guard=tmon.GuardConfig(ckpt_root=root))
    states = str(tmp_path / "trainer.states")
    trainer.save_states(states)
    trainer.load_states(states)
    assert trainer.checkpoint(root) == 0
    assert trainer.restore(root) == 0
    with pytest.raises(MXNetError, match="fp16 dynamic loss scaling"):
        tpar.ShardedTrainer(tnet, tmx.gluon.loss.L2Loss(), "sgd",
                            mesh=_port_mesh(), compute_dtype="float16",
                            guard=tmon.GuardConfig(mode="deferred"))
