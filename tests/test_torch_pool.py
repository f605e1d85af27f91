"""The port's replica tier (mxnet_tpu_torch/serving/wire.py, worker.py,
pool.py and elastic/membership.py) against the JAX package's on the CPU.

- wire: a frame written by either package is byte-identical to the
  other's and is read back by it; the caps refuse a garbage prefix;
  ``_error_doc`` of each structured error is equal key for key.
- membership: a ``Heartbeat`` of either package writes the same bytes
  and is read as alive by the other's ``LivenessReader``, as lost once
  its ``seq`` stalls past the deadline, and as gone once it resigns.
- the pool over ``LocalReplica``s of the worker's ``mlp`` (one seeded
  set of weights, carried into the port through ``convert``): answers
  within 1e-5 of the JAX pool's; ``kill()`` → ``replica_lost`` →
  respawn under the monitor with every request answered; ``drain`` and
  ``reload(surge=1)`` onto a committed step; ``PoolConfig.trace_dir``
  taken and the refusal of ``aot_dir``, which is not ported yet.
- two ``ProcReplica`` workers (``--ctx cpu``) behind the router, one
  SIGKILLed mid-burst and respawned by the monitor.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest

from mxnet_tpu.elastic import membership as jmem
from mxnet_tpu.resilience import commit as jcommit
from mxnet_tpu.serving import Router as JRouter
from mxnet_tpu.serving import RouterConfig as JRouterConfig
from mxnet_tpu.serving import batcher as jb
from mxnet_tpu.serving import pool as jpool
from mxnet_tpu.serving import wire as jwire
from mxnet_tpu.serving.reload import ParamStore as JStore
from mxnet_tpu.serving.worker import _error_doc as jerror_doc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.elastic import membership as tmem
from mxnet_tpu_torch.serving import Router as TRouter
from mxnet_tpu_torch.serving import RouterConfig as TRouterConfig
from mxnet_tpu_torch.serving import batcher as tb
from mxnet_tpu_torch.serving import pool as tpool
from mxnet_tpu_torch.serving import wire as twire
from mxnet_tpu_torch.serving.reload import ParamStore as TStore
from mxnet_tpu_torch.serving.worker import _error_doc as terror_doc

import torch_pool_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = {"jax": jwire, "port": twire}
MEMBERSHIP = {"jax": jmem, "port": tmem}


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    tp.quiet_journals()
    yield
    tp.quiet_journals()


class _Sock:
    """Enough of a socket for send_frame/recv_frame."""

    def __init__(self, data=b""):
        self.sent = bytearray()
        self.data = bytes(data)

    def sendall(self, b):
        self.sent += b

    def recv(self, n):
        chunk, self.data = self.data[:n], self.data[n:]
        return chunk


FRAMES = [
    ({"cmd": "predict", "shape": [2, 3], "dtype": "float32",
      "deadline_ms": 1500.0, "v": 1},
     np.arange(6, dtype=np.float32).reshape(2, 3).tobytes()),
    ({"cmd": "decode", "count": 3, "deadline_ms": None, "max_new": 5,
      "v": 1}, np.asarray([4, 5, 6], np.int32).tobytes()),
    ({"cmd": "stats"}, b""),
    ({"ok": False, "v": 1, "error": "DeadlineExceeded", "retryable": False,
      "detail": "late — ü", "stage": "dequeue", "late_ms": 3.5,
      "trace": {"trace_id": "ab", "span_id": "cd"}}, b""),
]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("frame", range(len(FRAMES)))
def test_wire_frames_byte_identical_and_read_back(writer, reader, frame):
    header, payload = FRAMES[frame]
    a, b = _Sock(), _Sock()
    WIRES[writer].send_frame(a, header, payload)
    WIRES[reader].send_frame(b, header, payload)
    assert bytes(a.sent) == bytes(b.sent)
    got_h, got_p = WIRES[reader].recv_frame(_Sock(a.sent))
    assert got_h == header and got_p == payload
    assert twire.PROTOCOL_VERSION == jwire.PROTOCOL_VERSION
    assert (twire.MAX_HEADER, twire.MAX_PAYLOAD) == \
        (jwire.MAX_HEADER, jwire.MAX_PAYLOAD)


def test_wire_refuses_garbage_alike():
    bad = [b"\xff\xff\xff\xff\x00\x00\x00\x00", b"\x00\x00\x00\x02\x00\x00"
           b"\x00\x00[]", b"\x00\x00\x00\x05\x00\x00\x00\x00{\"a\"",
           b"\x00\x00\x00\x02\x00\x00\x00\x00\xff\xfe"]
    for raw in bad:
        msgs = []
        for w in (jwire, twire):
            with pytest.raises(w.WireError) as ei:
                w.recv_frame(_Sock(raw))
            msgs.append(str(ei.value).split(":")[0])
        assert msgs[0] == msgs[1]


def _errors(b, pool):
    out = [b.DeadlineExceeded("dequeue", 12.5),
           b.DeadlineExceeded("router_budget", 3.0, tier="retry_budget"),
           b.ServerOverloaded(5, 8),
           b.ServerOverloaded(0, 2, tier="no_capacity"),
           b.ServerStopped("replica draining"),
           b.SlotsExhausted(8, queued=2), b.RequestCancelled("cancelled"),
           pool.ReplicaUnavailable("r1", "no port in beacon yet")]
    plain = b.RequestError("bad shape")
    plain.retryable = False
    return out + [plain]


def test_error_docs_equal_key_for_key():
    req = {"cmd": "predict", "trace": {"trace_id": "t", "span_id": "s"}}
    for je, te in zip(_errors(jb, jpool), _errors(tb, tpool)):
        for header in (None, req):
            assert terror_doc(te, header) == jerror_doc(je, header)


@pytest.mark.parametrize("writer,reader", [(w, r) for w in tp.PKGS
                                           for r in tp.PKGS])
def test_heartbeat_read_across_packages(tmp_path, writer, reader):
    payload = {"ready": True, "port": 4321, "queue_depth": 0}
    hb = MEMBERSHIP[writer].Heartbeat(str(tmp_path), "r0", 0.05,
                                      payload=lambda: payload,
                                      prefix="replica")
    rd = MEMBERSHIP[reader].LivenessReader(str(tmp_path), deadline_s=0.3,
                                           prefix="replica")
    hb.start()
    try:
        assert rd.alive("r0") and rd.payload("r0")["port"] == 4321
        assert rd.members() == ["r0"]
        time.sleep(0.2)
        assert rd.alive("r0")
    finally:
        hb.stop(resign=False)          # the seq stalls, the file stays
    rd.observe("r0")
    time.sleep(0.45)
    assert not rd.alive("r0")
    assert rd.payload("r0")["ready"] is True   # stale but kept
    hb.stop(resign=True)
    rd.observe("r0")
    assert rd.payload("r0") is None


def test_heartbeat_bytes_identical(tmp_path):
    raw = []
    for pkg in tp.PKGS:
        d = tmp_path / pkg
        hb = MEMBERSHIP[pkg].Heartbeat(str(d), "w1", 1.0, prefix="replica",
                                       payload=lambda: {"ready": False,
                                                        "params_step": 3})
        hb.beat()
        hb.beat()
        raw.append((d / "replica-w1.json").read_bytes())
    assert raw[0] == raw[1]


def _routers(pkg, pool, **kw):
    cls, cfg = (JRouter, JRouterConfig) if pkg == "jax" \
        else (TRouter, TRouterConfig)
    return cls(pool, cfg(**kw))


def test_pool_answers_match_jax_pool(tmp_path):
    x = np.random.RandomState(3).randn(16, tp.DIM).astype(np.float32)
    got = {}
    for pkg in tp.PKGS:
        pool = tp.local_pool(pkg, str(tmp_path / pkg)).start()
        router = _routers(pkg, pool, retries=2)
        try:
            resp = [router.call(row) for row in x]
            got[pkg] = np.stack([r.value for r in resp])
            assert {r.replica for r in resp} <= {"r0", "r1"}
            assert all(r.params_step is None and r.attempts == 1
                       for r in resp)
            view = pool.view()
            assert [(s.id, s.alive, s.ready) for s in view] == \
                [("r0", True, True), ("r1", True, True)]
            got[pkg + "_view"] = sorted(vars(view[0]))
        finally:
            router.stop()
            pool.stop()
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["port"], tp.mlp_forward(x), atol=1e-5)
    assert got["port_view"] == got["jax_view"]


def test_kill_respawn_under_monitor_alike(tmp_path):
    """``kill()`` stops r1's heartbeat without resigning and tears its
    server away: the monitor journals ``replica_lost`` and restarts it,
    while the router retries every request on r0."""
    x = np.random.RandomState(4).randn(tp.DIM).astype(np.float32)
    outcome = {}
    for pkg in tp.PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        tp.journal_to(pkg, path)
        pool = tp.local_pool(pkg, str(tmp_path / pkg), heartbeat_s=0.05,
                             deadline_s=0.3, monitor_s=0.05).start()
        router = _routers(pkg, pool, retries=3)
        try:
            pool.monitor_start()
            first = pool.replicas["r1"].server
            pool.replicas["r1"].kill()
            answered = 0
            t_end = time.monotonic() + 30
            while time.monotonic() < t_end:
                np.testing.assert_allclose(router.predict(x),
                                           tp.mlp_forward(x), atol=1e-5)
                answered += 1
                st = {s.id: s for s in pool.view()}["r1"]
                if tp.records(path, "replica_lost") and st.ready:
                    break
            lost = tp.records(path, "replica_lost")
            outcome[pkg] = ([r["replica"] for r in lost],
                            lost[0]["respawns"],
                            pool.replicas["r1"].server is not first)
            assert answered and pool._respawns == {"r1": 1}
        finally:
            pool.monitor_stop()
            router.stop()
            pool.stop()
            tp.quiet_journals()
    assert outcome["port"] == outcome["jax"] == (["r1"], 0, True)


def _commit_mlp(pkg, root, step, arrays):
    if pkg == "jax":
        net = tp.mlp("jax", arrays)
        stage = jcommit.prepare_stage(root, step)
        net.save_parameters(os.path.join(stage, "model.params"))
        jcommit.finalize(root, step)
    else:
        from mxnet_tpu_torch.resilience import commit as tcommit
        net = tp.mlp("port", arrays)
        stage = tcommit.prepare_stage(root, step)
        net.save_parameters(os.path.join(stage, "model.params"))
        tcommit.finalize(root, step)


def test_drain_and_rolling_reload_alike(tmp_path):
    x = np.random.RandomState(5).randn(8, tp.DIM).astype(np.float32)
    step2 = tp.mlp_arrays(seed=9)
    outcome = {}
    for pkg in tp.PKGS:
        ck = str(tmp_path / f"ckpt-{pkg}")
        _commit_mlp(pkg, ck, 1, tp.mlp_arrays())
        store = JStore if pkg == "jax" else TStore
        pool = tp.local_pool(
            pkg, str(tmp_path / pkg),
            factory=lambda pkg=pkg, ck=ck, store=store: tp.server(
                pkg, store=store(ck), reload_poll_s=-1.0)).start()
        router = _routers(pkg, pool, retries=3)
        try:
            assert [s.params_step for s in pool.view()] == [1, 1]
            residual = pool.drain("r0", deadline_s=5.0)
            pool._view_cache = (None, 0.0)
            drained = {s.id: (s.ready, s.draining) for s in pool.view()}
            assert all(router.call(row).replica == "r1" for row in x[:4])
            _commit_mlp(pkg, ck, 2, step2)
            steps = pool.reload(surge=1)
            if pkg == "port":
                assert steps == {"r0": 2, "r1": 2}
            pool._view_cache = (None, 0.0)
            resp = [router.call(row) for row in x]
            np.testing.assert_allclose(np.stack([r.value for r in resp]),
                                       tp.mlp_forward(x, step2), atol=1e-5)
            outcome[pkg] = (residual, drained,
                            {s.id: s.params_step for s in pool.view()},
                            {r.params_step for r in resp})
        finally:
            router.stop()
            pool.stop()
    assert outcome["port"] == outcome["jax"] == (
        0, {"r0": (False, True), "r1": (True, False)},
        {"r0": 2, "r1": 2}, {2})


def test_pool_refuses_unported_parts(tmp_path):
    assert tpool.PoolConfig(trace_dir=str(tmp_path)).trace_dir == \
        str(tmp_path)
    with pytest.raises(NotImplementedError, match="item 5g"):
        tpool.PoolConfig(aot_dir=str(tmp_path))
    with pytest.raises(MXNetError, match="must exceed"):
        tpool.PoolConfig(heartbeat_s=1.0, deadline_s=0.5)
    with pytest.raises(MXNetError):
        tpool.PoolConfig(surge=0)


def test_proc_workers_sigkill_respawn(tmp_path):
    """Two subprocess workers (``python -m mxnet_tpu_torch.serving
    worker --model mlp --ctx cpu``) behind the router: one SIGKILLed
    mid-burst, every request answered, the monitor respawns it."""
    from mxnet_tpu_torch.serving.worker import _build_block
    import mxnet_tpu_torch as tmx
    import torch
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_TPU_JOURNAL="off")
    pool = tpool.ReplicaPool(str(tmp_path / "pool"), tpool.PoolConfig(
        heartbeat_s=0.1, deadline_s=1.0, monitor_s=0.1, spawn_s=60.0))
    for rid in ("w0", "w1"):
        pool.add_proc(rid, {"--model": "mlp", "--ctx": "cpu",
                            "--window-ms": 1.0, "--reload-poll-s": -1.0},
                      env=env)
    x = np.random.RandomState(6).randn(tp.DIM).astype(np.float32)
    with torch.inference_mode():
        want = _build_block("mlp", tp.DIM, tmx.cpu())(
            torch.from_numpy(x[None]))[0].numpy()
    pool.start()
    router = TRouter(pool, TRouterConfig(retries=3))
    try:
        pool.monitor_start()
        victim = pool.replicas["w1"]
        pid = victim.pid()
        answers, errors = [], []

        def client():
            for _ in range(40):
                try:
                    answers.append(router.predict(x, deadline_ms=20000))
                except Exception as exc:
                    errors.append(repr(exc))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        tp.wait(lambda: len(answers) >= 8)
        os.kill(pid, signal.SIGKILL)
        for t in threads:
            t.join(120)
        assert not errors and len(answers) == 160
        np.testing.assert_allclose(np.stack(answers),
                                   np.stack([want] * 160), atol=1e-5)
        tp.wait(lambda: victim.pid() != pid and {
            s.id: s.ready for s in pool.view()}["w1"], timeout_s=60)
        header, _ = victim._roundtrip({"cmd": "stats"})
        assert header["stats"]["kernels_built"] == []
        assert set(header["stats"]["kernel_launches"]) >= {"matmul_epilogue"}
        np.testing.assert_allclose(router.predict(x), want, atol=1e-5)
    finally:
        router.stop()
        pool.stop()
    assert all(rep.proc is None for rep in pool.replicas.values())
