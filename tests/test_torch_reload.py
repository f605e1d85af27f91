"""Hot reload in the port (mxnet_tpu_torch/serving/reload.py and
``Server(param_store=)``) against the JAX package's ``ParamStore`` and
``Server``, on commit roots written by the port's
``ShardedTrainer.checkpoint`` and by the JAX package's
``resilience.commit`` (``prepare_stage`` + ``save_parameters`` +
``finalize``).

- The same sequence of ``poll``, ``pin_step``, ``load_step`` and
  ``mark_bad`` on both packages' stores over one root picks the same
  steps, loads the same values and keeps the same ``corrupt_seen``,
  ``loaded_step`` and LRU of bad steps: a torn step (a byte flipped
  after the commit: CRC mismatch, corruption), a GC race (the step's
  file gone between listing and read: skipped, not corruption), the
  cap on remembered bad steps, a pin and a downgrade.
- ``Server(ctx=cpu(), param_store=...)`` starts on the newest
  JAX-written step; its responses carry that step and match the JAX
  block's forward with those weights within 1e-5 of max |value|; a
  newer step from a narrower model is refused with nothing applied
  (``serving_reload_failed``) and the server stays on its step;
  ``pin_params(1)`` rolls it back to step 1 at its next turn.
"""
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.resilience import commit as jcommit
from mxnet_tpu.serving.reload import ParamStore as JStore
from mxnet_tpu_torch.diagnostics.journal import get_journal
from mxnet_tpu_torch.resilience import commit as tcommit
from mxnet_tpu_torch.serving import ParamStore as TStore
from mxnet_tpu_torch.serving import Server, ServerConfig

IN, HIDDEN, OUT = 8, 16, 4


def _jax_mlp(hidden=HIDDEN, seed=0):
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(hidden, activation="relu"),
            jmx.gluon.nn.Dense(OUT))
    net.initialize(ctx=jmx.cpu())
    net(jmx.nd.array(np.zeros((1, IN), np.float32)))
    rng = np.random.RandomState(seed)
    for p in net._structural_names().values():
        p.set_data(jmx.nd.array(rng.randn(*p.shape).astype(np.float32)))
    return net


def _jax_root(root, steps, hidden=HIDDEN):
    """JAX-written committed steps, one seeded MLP per step."""
    for step in steps:
        stage = jcommit.prepare_stage(root, step)
        _jax_mlp(hidden, seed=step).save_parameters(
            os.path.join(stage, "model.params"))
        jcommit.finalize(root, step)


def _port_root(root, steps):
    """Port-written committed steps: a ShardedTrainer's checkpoint after
    each of its steps (``arg:``/``aux:`` keys and the meta entry)."""
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(HIDDEN, activation="relu", in_units=IN),
            tmx.gluon.nn.Dense(OUT, in_units=HIDDEN))
    net.initialize(ctx=tmx.cpu(), generator=tmx.random.generator(0))
    tr = tmx.parallel.ShardedTrainer(
        net, tmx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.1},
        mesh=tmx.parallel.make_mesh({"data": 1}, devices=[tmx.cpu()]))
    rng = np.random.RandomState(0)
    x, y = rng.randn(6, IN), rng.randn(6, OUT)
    for step in steps:
        tr.step(x, y)
        tr.checkpoint(root, step=step)


def _flip_byte(root, step, commit_mod):
    d = commit_mod.step_dir(root, step)
    name = sorted(n for n in os.listdir(d) if n.endswith(".params"))[0]
    with open(os.path.join(d, name), "r+b") as f:
        f.seek(40)
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 0xFF]))


def _values(loaded):
    out = {}
    for k, v in loaded.items():
        if k.startswith("__"):
            continue
        out[k] = v.asnumpy() if hasattr(v, "asnumpy") else v.numpy()
    return out


def _scenario(store_cls, nd_mod, root, monkeypatch, reader="load"):
    """One sequence of store calls; what each returned and the store's
    bookkeeping after it. ``reader`` is the function of ``nd_mod`` the
    store reads files with (the port's reads tensors)."""
    real = getattr(nd_mod, reader)
    step_4 = tcommit.step_dir(root, 4) + os.sep

    def gone_for_step_4(fname):
        if fname.startswith(step_4):
            raise FileNotFoundError(fname)        # a trainer's GC won
        return real(fname)

    monkeypatch.setattr(nd_mod, reader, gone_for_step_4)
    store = store_cls(root, max_bad_steps=1)
    trace = []

    def note(what, got):
        step, vals = (None, None) if got is None else (got[0],
                                                       _values(got[1]))
        trace.append((what, step, vals, store.corrupt_seen,
                      store.loaded_step, list(store._bad_steps)))

    note("poll", store.poll())          # 5 torn, 4 gone: 3
    note("poll", store.poll())          # 5 again (evicted), then nothing
    store.pin_step(2)
    note("pinned poll", store.poll())
    note("load_step 1", store.load_step(1))
    note("pinned poll", store.poll())   # 2 is newer than 1
    store.mark_bad(2, revert_to=1)
    note("mark_bad", None)
    store.pin_step(None)
    note("poll", store.poll())          # 5 and 4 skipped again: 3
    with pytest.raises(ValueError):
        store.load_step(5)
    monkeypatch.setattr(nd_mod, reader, real)
    return trace


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:], (g[0], g[3:], w[3:])
        if w[2] is None:
            assert g[2] is None
            continue
        assert set(g[2]) == set(w[2])
        for k in w[2]:
            np.testing.assert_array_equal(g[2][k].astype(np.float32),
                                          w[2][k].astype(np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_param_store_picks_the_same_steps_as_jax(writer, tmp_path,
                                                 monkeypatch):
    root = str(tmp_path / "root")
    if writer == "jax":
        _jax_root(root, [1, 2, 3, 4, 5])
    else:
        _port_root(root, [1, 2, 3, 4, 5])
    _flip_byte(root, 5, tcommit)
    got = _scenario(TStore, tmx.ndarray, root, monkeypatch,
                    reader="_load_tensors")
    want = _scenario(JStore, jmx.ndarray, root, monkeypatch)
    _same(got, want)
    assert [t[1] for t in got] == [3, None, None, 1, 2, None, 3]
    assert [t[3] for t in got] == [1, 2, 2, 2, 2, 2, 3]   # corrupt_seen
    assert got[-2][4] == 1 and got[-1][5] == [4]      # reverted; the LRU


def _wait(cond, what, timeout_s=20.0):
    t_end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _served(server, x):
    resp = server.submit(x)
    return resp.result(30.0), resp.params_step


def test_server_hot_reloads_jax_steps(tmp_path):
    root = str(tmp_path / "root")
    _jax_root(root, [1, 2, 3])
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(HIDDEN, activation="relu"),
            tmx.gluon.nn.Dense(OUT))
    net.initialize(ctx=tmx.cpu())
    net(torch.zeros(1, IN))
    store = TStore(root)
    server = Server(net, ServerConfig(max_batch=4, reload_poll_s=0.0),
                    param_store=store, ctx=tmx.cpu()).start()
    xs = np.random.RandomState(4).randn(3, IN).astype(np.float32)

    def check(step):
        want = _jax_mlp(seed=step)(jmx.nd.array(xs)).asnumpy()
        for i, x in enumerate(xs):
            out, served_step = _served(server, x)
            assert served_step == step
            scale = float(np.abs(want[i]).max())
            assert float(np.abs(out - want[i]).max()) <= 1e-5 * scale

    try:
        stats = server.stats()
        assert stats["params_step"] == 3 and stats["reloads"] == 1
        check(3)
        before = {k: v.clone() for k, v in net.collect_params().items()}
        _jax_root(root, [4], hidden=HIDDEN // 2)         # drift
        _wait(lambda: 4 in store._bad_steps, "the drifted step's refusal")
        for k, v in net.collect_params().items():
            assert torch.equal(v, before[k]), k
        assert server.stats()["params_step"] == 3 and store.corrupt_seen == 0
        check(3)
        kinds = [r["kind"] for r in get_journal().recent()]
        assert "serving_reload_failed" in kinds and "serving_reload" in kinds
        assert server.pin_params(1)
        _wait(lambda: server.stats()["params_step"] == 1, "the pinned step")
        check(1)
        assert server.stats()["reloads"] == 2
    finally:
        server.stop()
    assert Server(net, ctx=tmx.cpu()).pin_params(1) is False


def test_the_worker_serves_while_a_step_loads(tmp_path):
    """The load runs on the loader thread: while it is held, requests are
    answered on the old step; once it returns, the worker applies the
    new step between batches. ``stop()`` with a loaded step not yet
    applied hands it back to the store, so a restart serves it."""
    import threading
    root = str(tmp_path / "root")
    _jax_root(root, [1])
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(HIDDEN, activation="relu"),
            tmx.gluon.nn.Dense(OUT))
    net.initialize(ctx=tmx.cpu())
    net(torch.zeros(1, IN))
    gate, polled = threading.Event(), threading.Event()

    class HeldStore(TStore):
        def poll(self):
            if self.loaded_step is not None:      # start()'s poll is free
                polled.set()
                assert gate.wait(20.0)
            return super().poll()

    store = HeldStore(root)
    server = Server(net, ServerConfig(max_batch=4, reload_poll_s=0.0),
                    param_store=store, ctx=tmx.cpu()).start()
    x = np.random.RandomState(5).randn(IN).astype(np.float32)
    try:
        _jax_root(root, [2])
        assert polled.wait(20.0)
        for _ in range(3):                        # the load is held
            assert _served(server, x)[1] == 1
        gate.set()
        _wait(lambda: server.stats()["params_step"] == 2, "step 2")
        assert _served(server, x)[1] == 2
        gate.clear()
        polled.clear()
        _jax_root(root, [3])
        assert polled.wait(20.0)
        threading.Timer(0.2, gate.set).start()
        server.stop()                             # step 3 loads, unapplied
        assert server.stats()["params_step"] == 2
        server.start()                            # offered again
        assert server.stats()["params_step"] == 3
        assert _served(server, x)[1] == 3
    finally:
        gate.set()
        server.stop()
