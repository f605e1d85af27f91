"""The port's trace sites (serving/server.py, router.py, pool.py,
worker.py; parallel/sharded.py, gluon/trainer.py) against the JAX
package's on the CPU, over the worker's ``mlp`` with one seeded set of
weights in both packages (``torch_pool_parity``).

- span trees: the same session through each package's Server (queued
  requests served as one batch, a shed request, a request re-anchored
  under a wire parent, a prewarmed server) and Router (calls over two
  prewarmed in-process replicas) gives the same multiset of (name,
  parent's name, attribute keys). The kernel tier's ``pallas.*`` notes
  are left out: the JAX package writes them when it traces a program,
  the port's CPU path at every eager call;
- ``Server.metrics_text`` and ``Router.metrics_text``: the same event
  values as the JAX package's after the same session; ``/metrics``
  served over loopback;
- ``PoolConfig(trace_dir=)``: two ``--ctx cpu`` worker processes behind
  a journal-traced router, one SIGKILLed; the run directory merged into
  one trace id across the router's journal and a worker's, the killed
  worker's flight dump read back, and both packages' aggregators giving
  one document;
- both trainers: the same count of ``.item``/``.cpu``/``.tolist`` calls
  with tracing off and on, and their spans and phases; the decode
  engine's program builds as ``xla_compile`` spans.
"""
import os
import re
import signal
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.observability import aggregate as jagg
from mxnet_tpu.observability import flight as jflight
from mxnet_tpu.observability import trace as jtrace
from mxnet_tpu.serving import Router as JRouter
from mxnet_tpu.serving import RouterConfig as JRouterConfig
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.diagnostics import journal as tjournal
from mxnet_tpu_torch.observability import aggregate as tagg
from mxnet_tpu_torch.observability import flight as tflight
from mxnet_tpu_torch.observability import trace as ttrace
from mxnet_tpu_torch.serving import Router as TRouter
from mxnet_tpu_torch.serving import RouterConfig as TRouterConfig
from mxnet_tpu_torch.serving import pool as tpool

import torch_pool_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACES = {"jax": jtrace, "port": ttrace}
ROUTERS = {"jax": (JRouter, JRouterConfig), "port": (TRouter, TRouterConfig)}


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    monkeypatch.setenv("MXNET_TPU_POD_RUN_ID", "pod-test")
    for name in ("MXNET_TPU_TRACE", "MXNET_TPU_TRACE_DIR",
                 "MXNET_TPU_REPLICA_ID"):
        monkeypatch.delenv(name, raising=False)
    tp.quiet_journals()
    yield
    for tr in TRACES.values():
        tr.configure(mode="off")
    tp.quiet_journals()


def _shape(spans):
    """Multiset of (name, parent's name, attribute keys): a parent
    outside the spans is "<remote>"."""
    names = {s["span_id"]: s["name"] for s in spans}
    return Counter(
        (s["name"],
         names.get(s["parent_id"], "<remote>") if s["parent_id"] else None,
         tuple(sorted(k for k in s.get("attrs") or {}
                      if not k.startswith("pallas."))))
        for s in spans)


def _events(text, family, **labels):
    """{event label: value} of one family's samples whose other labels
    equal ``labels``."""
    out = {}
    for m in re.finditer(rf'^{family}{{([^}}]*)}} (\S+)$', text, re.M):
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        if all(got.get(k) == v for k, v in labels.items()):
            out[got["event"]] = float(m.group(2))
    return out


def _server_session(pkg):
    """Four requests queued before start() (one batch), a fifth shed, one
    re-anchored under a wire parent, then a prewarmed server's answer."""
    tr = TRACES[pkg]
    tracer = tr.configure(mode="ring")
    x = np.random.RandomState(0).randn(6, tp.DIM).astype(np.float32)
    srv = tp.server(pkg, max_batch=4, max_queue=4, window_ms=100.0)
    pending = [srv.submit(x[i]) for i in range(4)]
    with pytest.raises(Exception, match="queue full"):
        srv.submit(x[4])
    srv.start()
    outs = [p.result(60) for p in pending]
    parent = tr.SpanContext("feedface000001", "0000beef")
    outs.append(srv.submit(x[5], parent=parent).result(60))
    text = srv.metrics_text()
    sid = srv._metrics_id
    srv.stop()
    warm = tp.server(pkg, max_batch=2, aot_prewarm=((tp.DIM,),)).start()
    outs.append(warm.predict(x[0]))
    warm.stop()
    return tracer.spans(), text, sid, outs


def test_server_span_trees_and_metrics_match_jax():
    got, want = _server_session("port"), _server_session("jax")
    np.testing.assert_allclose(np.stack(got[3]), np.stack(want[3]),
                               atol=1e-5)
    assert _shape(got[0]) == _shape(want[0])
    shape = _shape(got[0])
    assert shape[("serving_request", None, ("shape", "status"))] == 6
    assert shape[("serving_request", "<remote>", ("shape", "status"))] == 1
    assert shape[("xla_compile", None, ("aot", "dtype", "shape", "site"))] \
        == 2
    assert shape[("xla_compile", "serving_batch",
                  ("bucket", "dtype", "includes_execute", "key",
                   "site"))] == 2
    remote = [s for s in got[0] if s["parent_id"] == "0000beef"]
    assert [s["trace_id"] for s in remote] == ["feedface000001"]
    statuses = Counter(s["attrs"]["status"] for s in got[0]
                       if s["name"] == "serving_request")
    assert statuses == {"ok": 6, "shed": 1}
    for family in ("mxnet_tpu_serving_events",
                   "mxnet_tpu_serving_cache_events"):
        assert _events(got[1], family, server=got[2]) == \
            _events(want[1], family, server=want[2])
    assert _events(got[1], "mxnet_tpu_serving_events", server=got[2])[
        "shed"] == 1.0


def _router_session(pkg, root):
    pool = tp.local_pool(pkg, root, n=2, factory=lambda: tp.server(
        pkg, max_batch=2, aot_prewarm=((tp.DIM,),)))
    pool.start()
    cls, cfg = ROUTERS[pkg]
    router = cls(pool, cfg(retries=1))
    tracer = TRACES[pkg].configure(mode="ring")
    x = np.random.RandomState(1).randn(4, tp.DIM).astype(np.float32)
    try:
        values = [router.call(row).value for row in x]
        text = router.metrics_text()
        spans = tracer.spans()
    finally:
        router.stop()
        pool.stop()
    return spans, text, values


def test_router_span_trees_and_metrics_match_jax(tmp_path):
    got = _router_session("port", str(tmp_path / "port"))
    want = _router_session("jax", str(tmp_path / "jax"))
    np.testing.assert_allclose(np.stack(got[2]), np.stack(want[2]),
                               atol=1e-5)
    assert _shape(got[0]) == _shape(want[0])
    shape = _shape(got[0])
    assert shape[("router_request", None, ("priority", "tenant"))] == 4
    assert shape[("router_attempt", "router_request",
                  ("replica", "tenant"))] == 4
    assert shape[("serving_request", "router_attempt",
                  ("shape", "status"))] == 4
    by_id = {s["span_id"]: s for s in got[0]}
    for s in got[0]:
        if s["parent_id"]:
            assert s["trace_id"] == by_id[s["parent_id"]]["trace_id"]
    assert _events(got[1], "mxnet_tpu_router_events") == \
        _events(want[1], "mxnet_tpu_router_events")
    assert _events(got[1], "mxnet_tpu_router_events")["served"] == 4.0


def test_decode_program_builds_are_compile_spans():
    from mxnet_tpu_torch.serving import decode
    tobs.reset_metrics()
    tracer = ttrace.configure(mode="ring")
    eng = decode.DecodeEngine(decode.TinyLM(), decode.DecodeConfig(slots=2),
                              ctx=tmx.cpu())
    eng.start()
    try:
        eng.warmup()
        assert eng.submit([1, 2, 3], max_new_tokens=4).result(30) == \
            decode.TinyLM().reference([1, 2, 3], 4)
    finally:
        eng.stop()
    builds = [s for s in tracer.spans() if s["name"] == "xla_compile"]
    assert len(builds) == eng.stats()["compiles"] == 7
    assert {tuple(sorted(s["attrs"])) for s in builds} == {
        ("engine", "program", "site")}
    assert tobs.compile_stats()["by_site"] == {"decode_program": 7}


def test_metrics_endpoint_serves_the_text():
    srv = tp.server("port").start()
    try:
        srv.predict(np.zeros(tp.DIM, np.float32))
        httpd = srv.start_metrics_server()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
    finally:
        srv.stop()
    assert "# TYPE mxnet_tpu_serving_events gauge" in body
    assert srv._metrics_httpd is None


def test_pool_trace_dir_drill_with_a_sigkill(tmp_path):
    """Two ``--ctx cpu`` workers journal into ``trace_dir`` beside the
    router's journal; w1 is SIGKILLed after a periodic flight dump."""
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_TPU_TRACE_FLIGHT_S="0.1")
    pool = tpool.ReplicaPool(str(tmp_path / "pool"), tpool.PoolConfig(
        heartbeat_s=0.1, deadline_s=1.0, monitor_s=0.1, spawn_s=60.0,
        trace_dir=run_dir))
    for rid in ("w0", "w1"):
        pool.add_proc(rid, {"--model": "mlp", "--ctx": "cpu",
                            "--window-ms": 1.0, "--reload-poll-s": -1.0},
                      env=env)
    tjournal.reset_journal(os.path.join(run_dir, "journal-router.jsonl"))
    ttrace.configure(mode="journal")
    x = np.random.RandomState(6).randn(tp.DIM).astype(np.float32)
    router = TRouter(pool, TRouterConfig(retries=3))
    pool.start()
    try:
        first = [router.call(x) for _ in range(6)]
        assert {r.replica for r in first} == {"w0", "w1"}
        victim = pool.replicas["w1"]
        dump = os.path.join(run_dir, "flight-replica-w1.json")
        tp.wait(lambda: os.path.exists(dump) and any(
            s["name"] == "serving_request"
            for s in tflight.read_flight(dump)["spans"]))
        pid = victim.pid()
        os.kill(pid, signal.SIGKILL)
        after = [router.call(x) for _ in range(4)]
    finally:
        router.stop()
        pool.stop()
        ttrace.configure(mode="off")
        tjournal.reset_journal("off")
    assert {r.replica for r in after} == {"w0"}
    np.testing.assert_allclose(np.stack([r.value for r in first + after]),
                               np.stack([first[0].value] * 10), atol=1e-6)
    assert sorted(os.listdir(run_dir)) == [
        "flight-replica-w0.json", "flight-replica-w1.json",
        "journal-router.jsonl", "journal-w0.jsonl", "journal-w1.jsonl"]
    killed = tflight.read_flight(dump)
    assert killed == jflight.read_flight(dump)
    assert killed["pid"] == pid and killed["reason"] == "periodic"
    assert tflight.read_flight(os.path.join(
        run_dir, "flight-replica-w0.json"))["reason"] == "stop"
    procs = tagg.scan_run_dir(run_dir)
    assert [p.label for p in procs][1:] == ["replica w0", "replica w1"]
    assert all(p.identity["run_id"] == "pod-test" for p in procs)
    routed = {s["trace_id"] for s in procs[0].spans
              if s["name"] == "router_request"}
    crossing = {w: routed & {s["trace_id"] for s in p.spans
                             if s["name"] == "serving_request"}
                for w, p in zip(("w0", "w1"), procs[1:])}
    assert crossing["w0"] and crossing["w1"]
    path = tagg.critical_path(procs, sorted(crossing["w1"])[0])
    assert path["ok"] and len(path["processes"]) == 2
    assert {s["name"] for s in path["steps"]} >= {
        "router_request", "router_attempt", "serving_request", "execute"}
    assert tagg.aggregate_chrome(run_dir) == jagg.aggregate_chrome(run_dir)
    assert tagg.timeline_report(run_dir) == jagg.timeline_report(run_dir)


def _spy(monkeypatch):
    """Count ``.item``, ``.cpu`` and ``.tolist`` calls on tensors."""
    counts = Counter()
    for name in ("item", "cpu", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *args, _orig=orig, _name=name, **kwargs):
            counts[_name] += 1
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, spy)
    return counts


def _mlp():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(8, in_units=6, activation="relu"))
    net.add(tmx.gluon.nn.Dense(4, in_units=8))
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu(),
                   generator=tmx.random.generator(0))
    rng = np.random.RandomState(4)
    return net, torch.from_numpy(rng.randn(8, 6).astype(np.float32)), \
        torch.from_numpy(rng.randn(8, 4).astype(np.float32))


def _counted_steps(counts, run, steps=3):
    """{mode: host reads over ``steps`` calls of ``run``}, off then ring,
    and the ring's spans."""
    reads = {}
    for mode in ("off", "ring"):
        tracer = ttrace.configure(mode=mode)
        counts.clear()
        for _ in range(steps):
            run()
        reads[mode] = dict(counts)
    return reads, tracer.spans()


def test_gluon_trainer_phases_add_no_host_read(monkeypatch):
    net, x, y = _mlp()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01},
                                guard=tmx.guardrails.GuardConfig())
    loss = tmx.gluon.loss.L2Loss()

    def run():
        with tmx.autograd.record():
            lv = loss(net(x), y)
        tmx.autograd.backward(lv)
        trainer.step(8, loss=lv)

    run()
    counts = _spy(monkeypatch)
    tobs.reset_metrics()
    reads, spans = _counted_steps(counts, run)
    # the guard's one host read per step: .cpu() and .tolist()
    assert reads["off"] == reads["ring"] == {"cpu": 3, "tolist": 3}
    shape = _shape(spans)
    assert shape[("gluon_trainer.step", None, ("step",))] == 3
    for phase in ("allreduce", "guard_fetch", "update"):
        assert shape[(f"gluon_trainer.{phase}", "gluon_trainer.step",
                      ())] == 3
    phases = tobs.default_registry().snapshot()["mxnet_tpu_step_phase_ms"]
    assert phases["values"]["trainer=gluon_trainer,phase=update"][
        "count"] == 6


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_sharded_trainer_phases_add_no_host_read(monkeypatch, graphed):
    """``ShardedTrainer.step`` and ``run_steps``: eager on the CPU, or on
    the CPU stand-in of a CUDA graph (``test_torch_hybridize.Stub``),
    where ``compiled_step`` wraps each replay and each capture is one
    program build."""
    from test_torch_hybridize import Stub
    net, x, y = _mlp()
    trainer = tmx.parallel.ShardedTrainer(
        net, tmx.gluon.loss.L2Loss(), "sgd", {"learning_rate": 0.01},
        mesh=tmx.parallel.make_mesh({"data": 1, "model": 1},
                                    devices=[tmx.cpu()]),
        guard=tmx.guardrails.GuardConfig())
    if graphed:
        trainer._backend = Stub()
    tobs.reset_metrics()
    trainer.step(x, y)
    trainer.run_steps(x, y, num_steps=2)
    counts = _spy(monkeypatch)

    def run():
        trainer.step(x, y)
        trainer.run_steps(x, y, num_steps=2)

    reads, spans = _counted_steps(counts, run)
    # the guard's one host read per step or window: .cpu() and .tolist()
    assert reads["off"] == reads["ring"] == {"cpu": 6, "tolist": 6}
    shape = _shape(spans)
    assert shape[("sharded_trainer.step", None, ("step",))] == 3
    assert shape[("sharded_trainer.run_steps", None,
                  ("num_steps", "start_step"))] == 3
    for top in ("sharded_trainer.step", "sharded_trainer.run_steps"):
        for phase in ("data_wait", "compiled_step", "guard_fetch"):
            assert shape[(f"sharded_trainer.{phase}", top, ())] == 3
    assert "xla_compile" not in {s["name"] for s in spans}
    stats = tobs.compile_stats()
    assert stats["by_site"] == {"sharded_trainer.run_steps": 1,
                                "sharded_trainer.step": 1}
    assert len(trainer._programs) == (2 if graphed else 0)
