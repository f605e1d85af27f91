"""The port's span tracing (mxnet_tpu_torch/observability: trace,
instrument, export, flight, aggregate; diagnostics: journal, watchdog;
serving/wire.py's trace context) against the JAX package's on the CPU.

- exporters: ``spans_to_chrome`` on the same span dicts,
  ``to_chrome_trace`` of the same live spans (ids and times
  normalized), ``chrome_trace_from_journal`` of the same journal files;
- the aggregator: ``aggregate_chrome``, ``critical_path`` and
  ``timeline_report`` of one run-directory fixture (journals with
  anchors on skewed clocks, a respawned incarnation, a torn tail, a
  flight dump and its rotated predecessor): equal documents;
- ``prometheus_text`` of the registries both packages fill through the
  ring's drop counter and ``compile_span`` on one clock: equal;
- ``attach_trace``: byte-equal frames, on and off; ``extract_parent``;
- the port alone: the ring's bound and drop count, cross-thread
  parents, journal records inside a span carrying its ids, the shared
  no-op with tracing off, the kernel tier's route notes, the flight dump
  of a process after it exits and after a SIGKILL, and a watchdog stall
  dump.

Each test configures both tracers explicitly and gives each package its
own journal file: the two read the same ``MXNET_TPU_*`` variables.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.diagnostics import journal as jjournal
from mxnet_tpu.observability import aggregate as jagg
from mxnet_tpu.observability import export as jexport
from mxnet_tpu.observability import flight as jflight
from mxnet_tpu.observability import instrument as jinstr
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu.observability import trace as jtrace
from mxnet_tpu.serving import wire as jwire
from mxnet_tpu_torch import kernels as tkernels
from mxnet_tpu_torch.diagnostics import journal as tjournal
from mxnet_tpu_torch.diagnostics import watchdog as twatchdog
from mxnet_tpu_torch.observability import aggregate as tagg
from mxnet_tpu_torch.observability import export as texport
from mxnet_tpu_torch.observability import flight as tflight
from mxnet_tpu_torch.observability import instrument as tinstr
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.observability import trace as ttrace
from mxnet_tpu_torch.serving import wire as twire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jtrace, jjournal, jexport, jwire, jmetrics, jinstr),
        "port": (ttrace, tjournal, texport, twire, tmetrics, tinstr)}


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    for name in ("MXNET_TPU_TRACE", "MXNET_TPU_TRACE_DIR",
                 "MXNET_TPU_REPLICA_ID", "MXNET_TPU_POD_RUN_ID"):
        monkeypatch.delenv(name, raising=False)
    for j in (jjournal, tjournal):
        j.reset_journal("off")
    yield
    for tr, j in ((jtrace, jjournal), (ttrace, tjournal)):
        tr.configure(mode="off")
        j.reset_journal("off")


def _session(tr):
    """One span sequence: a root, nested children, an attribute update,
    a record with explicit endpoints, an event, and a child on another
    thread re-anchored under the root."""
    with tr.span("router_request", priority=0, tenant=None) as root:
        with tr.span("router_attempt", replica="r0", tenant=None):
            tr.annotate(note=1)
        sp = tr.start_span("serving_request", shape=[4])
        tr.event("enqueue", parent=sp, depth=1)
        t0 = time.perf_counter()
        tr.record("execute", parent=sp, t0=t0, t1=t0 + 0.001, batch=1)
        sp.end(status="ok")
        ctx = tr.current_context()
        th = threading.Thread(target=lambda: tr.span(
            "router_hedge_arm", parent=ctx, replica="r1").__enter__()
            .__exit__(None, None, None), name="arm")
        th.start()
        th.join()
        root.set_attrs(done=True)


def _normalized(doc):
    """A Chrome document with ids renumbered by first appearance and the
    times zeroed."""
    ids = {}

    def norm(v):
        return ids.setdefault(v, f"id{len(ids)}")

    out = []
    for ev in doc["traceEvents"]:
        ev = json.loads(json.dumps(ev))
        if ev["ph"] == "X":
            ev["ts"] = ev["dur"] = 0
            for k in ("trace_id", "span_id", "parent_id"):
                if k in ev["args"]:
                    ev["args"][k] = norm(ev["args"][k])
        out.append(ev)
    return {**doc, "traceEvents": out}


def test_to_chrome_trace_of_live_spans_matches_jax():
    docs = {}
    for pkg, (tr, _j, ex, *_rest) in PKGS.items():
        tr.configure(mode="ring")
        _session(tr)
        docs[pkg] = _normalized(ex.to_chrome_trace())
    assert docs["port"] == docs["jax"]
    assert [e["name"] for e in docs["port"]["traceEvents"]] == [
        "router_attempt", "enqueue", "execute", "serving_request",
        "router_hedge_arm", "router_request"]


SPANS = [
    {"name": "router_request", "trace_id": "t1", "span_id": "a1",
     "parent_id": None, "start_s": 0.5, "dur_s": 0.012, "rank": 0,
     "thread": "MainThread", "attrs": {"priority": 0}},
    {"name": "serving_request", "trace_id": "t1", "span_id": "b1",
     "parent_id": "a1", "start_s": 0.5012, "dur_s": 0.009, "rank": 0,
     "replica": "w1", "thread": "worker", "attrs": {"status": "ok"}},
    {"name": "serving_batch", "trace_id": "t2", "span_id": "b2",
     "parent_id": None, "start_s": 0.503, "dur_s": None, "rank": 1,
     "thread": None},
    {"name": "execute", "trace_id": "t1", "span_id": "b3",
     "parent_id": "b1", "start_s": 0.504, "dur_s": 0.004, "rank": 0,
     "replica": "w0", "thread": "worker"},
]


@pytest.mark.parametrize("spans", [SPANS[:1], SPANS[2:3], SPANS],
                         ids=["one-process", "rank-1", "replicas"])
@pytest.mark.parametrize("labels", [None, {(0, None): "the router"}])
def test_spans_to_chrome_matches_jax(spans, labels):
    assert texport.spans_to_chrome(spans, labels) == \
        jexport.spans_to_chrome(spans, labels)


def test_chrome_trace_from_journal_matches_jax(tmp_path):
    files = {}
    for pkg, (tr, j, *_rest) in PKGS.items():
        path = str(tmp_path / f"{pkg}.jsonl")
        j.reset_journal(path)
        tr.configure(mode="journal")
        _session(tr)
        tr.configure(mode="off")
        j.reset_journal("off")
        with open(path, "a") as f:
            f.write('{"kind": "span", "name": "torn", "trace')   # torn tail
        files[pkg] = path
    for path in files.values():
        assert texport.chrome_trace_from_journal(path) == \
            jexport.chrome_trace_from_journal(path)
    got, want = (_normalized(texport.chrome_trace_from_journal(files[p]))
                 for p in ("port", "jax"))
    assert got == want and len(got["traceEvents"]) == 6


def _jsonl(path, records, torn=False):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        if torn:
            f.write('{"kind": "span", "name": "execute", "tra')


def _span(name, trace_id, span_id, parent, start, dur, **extra):
    return {"kind": "span", "ts": 0.0, "name": name, "trace_id": trace_id,
            "span_id": span_id, "parent_id": parent, "start_s": start,
            "dur_s": dur, "rank": 0, "thread": "t", **extra}


def _run_dir(root):
    """A pod run directory: the router's journal, worker w0's journal
    (its clock 700 s off the router's, respawned once), worker w1's
    flight dumps (its journal went down with it), junk beside them."""
    os.makedirs(root)
    anchor = {"kind": "trace_anchor", "ts": 1.0, "wall_s": 1000.0,
              "perf_s": 50.0, "epoch_s": 40.0, "rank": 0, "pid": 11,
              "run_id": "pod-x"}
    _jsonl(os.path.join(root, "journal-router.jsonl"), [
        anchor,
        _span("router_request", "T1", "a1", None, 10.0, 0.030,
              attrs={"priority": 0}),
        _span("router_attempt", "T1", "a2", "a1", 10.001, 0.028,
              attrs={"replica": "w0"}),
        _span("router_request", "T2", "a3", None, 10.1, 0.050),
        _span("router_attempt", "T2", "a4", "a3", 10.101, 0.048,
              attrs={"replica": "w1"}),
        {"kind": "serving_batch", "ts": 2.0, "batch": 4},
        "not json at all"], torn=True)
    w0 = {"kind": "trace_anchor", "ts": 1.0, "wall_s": 1000.004,
          "perf_s": 700.0, "epoch_s": 695.0, "rank": 0, "pid": 22,
          "replica": "w0", "run_id": "pod-x"}
    w0b = dict(w0, wall_s=1005.0, perf_s=900.0, epoch_s=899.0, pid=23)
    _jsonl(os.path.join(root, "journal-w0.jsonl"), [
        w0,
        _span("serving_request", "T1", "00000001", "a2", 15.003, 0.020,
              replica="w0", attrs={"status": "ok"}),
        _span("enqueue", "T1", "00000002", "00000001", 15.0031, 0.0,
              replica="w0"),
        _span("execute", "T1", "00000003", "00000001", 15.010, 0.009,
              replica="w0", attrs={"batch": 2}),
        w0b,                               # the respawn: ids restart
        _span("serving_request", "T1", "00000001", "a2", 1.0, 0.002,
              replica="w0", attrs={"status": "shed"})])
    flight = {"kind": "flight", "reason": "periodic", "label": "replica-w1",
              "seq": 7, "anchor": {"wall_s": 1000.02, "perf_s": 300.0,
                                   "epoch_s": 290.0, "rank": 0, "pid": 33,
                                   "replica": "w1", "run_id": "pod-x"},
              "trace": {"mode": "journal", "ring_size": 4096, "in_ring": 2,
                        "recorded": 9, "dropped": 3},
              "spans": [
                  {"name": "serving_request", "trace_id": "T2",
                   "span_id": "00000005", "parent_id": "a4",
                   "start_s": 10.09, "dur_s": 0.040, "rank": 0,
                   "replica": "w1", "thread": "t",
                   "attrs": {"status": "ok"}},
                  {"name": "execute", "trace_id": "T2",
                   "span_id": "00000006", "parent_id": "00000005",
                   "start_s": 10.11, "dur_s": 0.010, "rank": 0,
                   "replica": "w1", "thread": "t"}],
              "journal_tail": [
                  {"kind": "serving_batch", "ts": 3.0},
                  _span("respond", "T2", "00000007", "00000005", 10.125,
                        0.0, replica="w1")],
              "last_phase": "replica_worker_serve", "rank": 0, "pid": 33,
              "replica": "w1", "run_id": "pod-x"}
    with open(os.path.join(root, "flight-replica-w1.json"), "w") as f:
        json.dump(flight, f)
    prev = dict(flight, reason="stop", seq=2, pid=31,
                anchor=dict(flight["anchor"], pid=31, epoch_s=100.0),
                spans=flight["spans"][:1], journal_tail=[])
    with open(os.path.join(root, "flight-replica-w1.prev-1.json"), "w") as f:
        json.dump(prev, f)
    with open(os.path.join(root, "flight-broken.json"), "w") as f:
        f.write("{")
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("ignored")
    return root


def test_aggregate_of_a_run_dir_matches_jax(tmp_path):
    run_dir = _run_dir(str(tmp_path / "run"))
    got, want = tagg.aggregate_chrome(run_dir), jagg.aggregate_chrome(run_dir)
    assert got == want
    assert got["metadata"]["processes"] == [
        "rank 0 (pid 11)", "replica w0", "replica w1"]
    tprocs, jprocs = tagg.scan_run_dir(run_dir), jagg.scan_run_dir(run_dir)
    for trace_id in (None, "T1", "T2", "nope"):
        assert tagg.critical_path(tprocs, trace_id) == \
            jagg.critical_path(jprocs, trace_id)
        assert tagg.timeline_report(run_dir, trace_id) == \
            jagg.timeline_report(run_dir, trace_id)
    path = tagg.critical_path(tprocs, "T2")
    assert path["ok"] and path["processes"] == ["rank 0 (pid 11)",
                                                "replica w1"]
    assert {s["name"] for s in path["steps"]} == {
        "execute", "respond", "router_attempt", "router_request",
        "serving_request"}
    for bad in (str(tmp_path / "missing"), str(tmp_path)):
        assert tagg.timeline_report(bad) == jagg.timeline_report(bad)


def test_prometheus_text_of_trace_families_matches_jax(monkeypatch):
    texts = {}
    for pkg, (tr, _j, _ex, _w, metrics, instr) in PKGS.items():
        metrics.reset_metrics()
        clock = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(instr, "time", type(
            "Clock", (), {"perf_counter": staticmethod(lambda: next(clock))}))
        tr.configure(mode="ring", ring=2)
        for i in range(5):
            with tr.span("s", i=i):
                pass
        for site in ("serving_predictor", "serving_predictor", "decode"):
            with instr.compile_span(site, bucket=1):
                pass
        with instr.step_phase("sharded_trainer", "compiled_step"):
            pass
        with instr.maybe_compile_span(False, "never"):
            pass
        assert tr.get_tracer().stats()["dropped"] == 7     # of 9 spans
        texts[pkg] = metrics.prometheus_text()
    assert texts["port"] == texts["jax"]
    assert "mxnet_tpu_trace_ring_drops_total 7" in texts["port"]
    assert 'mxnet_tpu_xla_compiles_total{site="serving_predictor"} 2' \
        in texts["port"]


class _Sock:
    def __init__(self):
        self.sent = bytearray()

    def sendall(self, b):
        self.sent += b


@pytest.mark.parametrize("mode", ["off", "ring"])
def test_attach_trace_frames_byte_equal(mode):
    frames = {}
    for pkg, (tr, _j, _ex, wire, *_rest) in PKGS.items():
        tr.configure(mode=mode)
        sock = _Sock()
        with tr.span("router_attempt", replica="w0") as sp:
            if mode != "off":
                sp.trace_id, sp.span_id = "0a1b2c3d000001", "0000002a"
            header = wire.attach_trace(
                {"cmd": "predict", "shape": [2], "dtype": "float32",
                 "deadline_ms": 1500.0})
        wire.send_frame(sock, header, b"\x00" * 8)
        frames[pkg] = bytes(sock.sent)
    assert frames["port"] == frames["jax"]
    assert (b'"trace"' in frames["port"]) == (mode != "off")
    for header in ({"trace": {"trace_id": "t", "span_id": "s"}},
                   {"trace": {"trace_id": 1, "span_id": "s"}},
                   {"trace": "garbage"}, {}):
        got, want = twire.extract_parent(header), jwire.extract_parent(header)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.trace_id, got.span_id) == (want.trace_id,
                                                   want.span_id)


def test_ring_bound_and_drops(tmp_path):
    path = str(tmp_path / "j.jsonl")
    stats = {}
    for pkg, (tr, j, _ex, _w, metrics, _i) in PKGS.items():
        j.reset_journal(path + pkg)
        metrics.reset_metrics()
        tr.configure(mode="ring", ring=3)
        for i in range(5):
            with tr.span("s", i=i):
                pass
        stats[pkg] = tr.get_tracer().stats()
        assert [s["attrs"]["i"] for s in tr.get_tracer().spans()] == [2, 3, 4]
        drops = [json.loads(line) for line in open(path + pkg)
                 if '"trace_ring_drops"' in line]
        assert [d["dropped"] for d in drops] == [1]
    assert stats["port"] == stats["jax"] == {
        "mode": "ring", "ring_size": 3, "in_ring": 3, "recorded": 5,
        "dropped": 2}


def test_cross_thread_parent_and_fresh_thread_root():
    ttrace.configure(mode="ring")
    got = {}
    with ttrace.span("root") as root:
        ctx = ttrace.current_context()

        def worker():
            with ttrace.span("child", parent=ctx) as sp:
                got["child"] = (sp.trace_id, sp.parent_id)
            with ttrace.span("orphan") as sp:
                got["orphan"] = (sp.trace_id, sp.parent_id)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert got["child"] == (root.trace_id, root.span_id)
    assert got["orphan"][0] != root.trace_id and got["orphan"][1] is None


def test_journal_records_carry_span_ids(tmp_path):
    path = str(tmp_path / "j.jsonl")
    tjournal.reset_journal(path)
    ttrace.configure(mode="journal")
    with ttrace.span("outer") as sp:
        tjournal.get_journal().event("inside", n=1)
    tjournal.get_journal().event("outside")
    recs = [json.loads(line) for line in open(path)]
    by_kind = {r["kind"]: r for r in recs}
    assert (by_kind["inside"]["trace_id"], by_kind["inside"]["span_id"]) \
        == (sp.trace_id, sp.span_id)
    assert "trace_id" not in by_kind["outside"]
    assert by_kind["span"]["name"] == "outer"
    anchor = by_kind["trace_anchor"]
    assert {"wall_s", "perf_s", "epoch_s", "rank", "pid"} <= set(anchor)
    assert "trace_id" not in anchor


def test_off_is_one_shared_noop(tmp_path):
    path = str(tmp_path / "j.jsonl")
    tjournal.reset_journal(path)
    tracer = ttrace.configure(mode="off")
    assert ttrace.span("a") is ttrace.span("b", x=1) is ttrace._NOOP
    assert ttrace.start_span("c") is ttrace.record("d") is \
        ttrace.event("e") is ttrace._NOOP
    with ttrace.span("a") as sp:
        assert sp is ttrace._NOOP
        assert ttrace.current_ids() == {} and not ttrace.annotate(x=1)
        tjournal.get_journal().event("rec")
    assert tracer.spans() == [] and tracer.stats()["recorded"] == 0
    assert [json.loads(line)["kind"] for line in open(path)] == ["rec"]
    assert "trace_id" not in json.loads(open(path).readline())


def test_kernel_entries_note_their_route():
    """Each kernel entry annotates the active span with ``pallas.<name>``:
    "plain" for a CPU tensor (the card's "cuda" is held in
    tests/test_torch_cuda.py)."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    ttrace.configure(mode="ring")
    g = torch.Generator().manual_seed(0)
    y = torch.randn(4, 8, generator=g)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g, requires_grad=True)
               for _ in range(3))
    with ttrace.span("step") as sp:
        tkernels.fused_conv_epilogue(y, torch.ones(8), torch.zeros(8),
                                     act_type="relu")
        tkernels.fused_matmul_epilogue(y, torch.zeros(8), act_type="gelu")
        fa.flash_attention(q, k, v, block_size=8).sum().backward()
    assert sp.attrs == {"pallas.conv_epilogue": "plain",
                        "pallas.matmul_epilogue": "plain",
                        "pallas.flash_attention": "plain",
                        "pallas.flash_attention_bwd": "plain"}
    ttrace.configure(mode="off")
    tkernels.fused_matmul_epilogue(y, torch.zeros(8))    # no span: no-op


_FLIGHT_CHILD = """
import sys, time
from mxnet_tpu_torch.observability import flight, trace
trace.configure(mode="ring")
flush = 0.05 if sys.argv[2] == "kill" else 0.0
flight.FlightRecorder(sys.argv[1], flush_s=flush).install()
with trace.span("work", step=1):
    pass
if sys.argv[2] == "kill":
    print("ready", flush=True)
    while True:
        time.sleep(0.01)
"""


def test_flight_dump_outlives_its_process(tmp_path):
    """A recorder's dump after a clean exit (the atexit finalizer) and
    after a SIGKILL (the periodic flush), read back by both packages."""
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_TPU_JOURNAL="off",
               MXNET_TPU_REPLICA_ID="w9")
    dirs = {how: str(tmp_path / how) for how in ("exit", "kill")}
    procs = {how: subprocess.Popen(
        [sys.executable, "-c", _FLIGHT_CHILD, d, how], env=env,
        stdout=subprocess.PIPE, text=True) for how, d in dirs.items()}
    try:
        assert procs["exit"].wait(60) == 0
        assert procs["kill"].stdout.readline().strip() == "ready"
        path = os.path.join(dirs["kill"], "flight-replica-w9.json")
        deadline = time.monotonic() + 30
        while not (os.path.exists(path) and tflight.read_flight(path)["spans"]):
            assert time.monotonic() < deadline, "no periodic dump"
            time.sleep(0.02)
        os.kill(procs["kill"].pid, signal.SIGKILL)
        procs["kill"].wait(30)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.stdout.close()
    for how, reason in (("exit", "final"), ("kill", "periodic")):
        path = os.path.join(dirs[how], "flight-replica-w9.json")
        got, want = tflight.read_flight(path), jflight.read_flight(path)
        assert got == want and got["reason"] == reason
        assert got["replica"] == "w9" and got["label"] == "replica-w9"
        assert [s["name"] for s in got["spans"]] == ["work"]
        assert {"wall_s", "perf_s", "epoch_s", "pid"} <= set(got["anchor"])


def test_watchdog_stall_dumps_the_flight_recorder(tmp_path):
    journal = tjournal.Journal(str(tmp_path / "j.jsonl"))
    rec = tflight.FlightRecorder(str(tmp_path), label="w", flush_s=0,
                                 journal=journal).install()
    dog = twatchdog.Watchdog(journal, interval_s=0.02, stall_s=0.05).start()
    try:
        deadline = time.monotonic() + 10
        while not os.path.exists(rec.path):
            assert time.monotonic() < deadline, "no stall dump"
            time.sleep(0.01)
    finally:
        dog.stop()
        rec.stop(dump=False)
        journal.close()
    assert tflight.read_flight(rec.path)["reason"] == "stall"
    kinds = [json.loads(line)["kind"] for line in open(tmp_path / "j.jsonl")]
    assert "stall" in kinds and "heartbeat" in kinds
