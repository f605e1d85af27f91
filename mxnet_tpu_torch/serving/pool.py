"""Replica pool — N serving replicas behind one health ledger
(counterpart of ``mxnet_tpu/serving/pool.py``).

The millions-of-users shape: one ``Server`` per replica — in-process
(:class:`LocalReplica`) or its own OS process (:class:`ProcReplica`,
``python -m mxnet_tpu_torch.serving worker``, its own CUDA context) —
each heartbeating a readiness beacon onto a shared-filesystem ledger
via ``elastic.membership.Heartbeat``.  The pool owns replica LIFECYCLE
(spawn, drain, restart, rolling reload, auto-respawn); the router
(serving/router.py) owns per-request placement and robustness, reading
replica health ONLY through :meth:`ReplicaPool.view` — i.e. only from
the ledger — so every router thread (and every separate router process
pointed at the same ledger) derives the same picture.

Failure semantics:

- a SIGKILLed/wedged replica's heartbeat seq stalls; ``view()`` flips
  ``alive`` False within the observer-clock deadline (no cross-host
  wall clock) and the monitor respawns it under a bounded crash-loop
  budget;
- ``drain()`` stops admission FIRST (the beacon flips not-ready), then
  lets the queue empty under a bounded deadline — in-flight work
  finishes, nothing new lands;
- ``restart()`` = drain + replace the worker; the fresh worker loads
  the newest CRC-valid committed step from its ``ParamStore`` root, so
  a restart is also the upgrade path;
- ``reload()`` rolls a restart across the fleet, at most ``surge``
  replicas out of rotation at once — zero shed beyond the surge margin
  while the router routes around the hole.

An in-process replica's fresh ``Server`` captures its CUDA graphs while
its peers serve: the port captures in "thread_local" mode
(``gluon/cached_graph.py``), so the peers' replays and host copies on
their own threads do not break the capture.

Pod-scope tracing: the pool publishes one pod run id
(``MXNET_TPU_POD_RUN_ID``) in its own process and in every worker's
environment, with the worker's ``MXNET_TPU_REPLICA_ID``. With
``PoolConfig.trace_dir`` set, each subprocess worker journals to its own
``<trace_dir>/journal-<rid>.jsonl`` in trace mode ``journal`` and runs
the flight recorder there; ``observability.aggregate`` merges the
directory into one trace. Request frames carry the router's trace
context.

Not ported yet: ``PoolConfig.aot_dir`` (the AOT store, ROADMAP Queue 1
item 5g); it raises when set.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..base import MXNetError
from ..diagnostics.journal import get_journal
from ..elastic.membership import Heartbeat, LivenessReader
from ..resilience import atomic as _atomic
from . import wire
from .batcher import (DeadlineExceeded, RequestError, ServerOverloaded,
                      ServerStopped, SlotsExhausted)

__all__ = ["DeployInProgress", "LocalReplica", "PoolConfig", "ProcReplica",
           "ReplicaPool", "ReplicaState", "ReplicaUnavailable"]


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class DeployInProgress(MXNetError):
    """A canary deployment owns the pool: fleet-mutating lifecycle ops
    (``reload``, another ``deploy``) are REFUSED, not queued — two
    concurrent version rollouts would tear the old-xor-new response
    contract mid-flight."""

    def __init__(self, owner, op):
        super().__init__(
            f"{op} refused: deployment {owner!r} is in progress — wait "
            "for it to promote or roll back (DeployController serializes "
            "fleet version changes)")
        self.owner = owner
        self.op = op


class ReplicaUnavailable(RequestError):
    """The replica could not be reached (connection refused/reset, no
    port in the beacon yet, torn reply): the transport twin of a dead
    rank.  Always retryable on a different replica."""

    retryable = True

    def __init__(self, replica, detail):
        super().__init__(f"replica {replica!r} unavailable: {detail}")
        self.replica = replica


@dataclass
class PoolConfig:
    """Replica-pool knobs (``MXNET_TPU_POOL_*`` env vars set defaults)."""

    heartbeat_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_POOL_HEARTBEAT_S", 0.5))
    deadline_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_POOL_DEADLINE_S", 3.0))      # hb stall -> replica lost
    drain_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_POOL_DRAIN_S", 20.0))        # bounded drain deadline
    spawn_s: float = 120.0                      # worker start -> ready
    surge: int = 1                              # reload() out-of-rotation cap
    max_respawns: int = 3                       # crash-loop budget/replica
    monitor_s: float = 0.5                      # auto-respawn poll interval
    poll_s: float = 0.05
    # shared run directory for pod-scope tracing: each subprocess worker
    # streams spans and journal to its own <trace_dir>/journal-<rid>.jsonl
    # and runs the flight recorder there
    trace_dir: object = field(default_factory=lambda: os.environ.get(
        "MXNET_TPU_TRACE_DIR") or None)
    aot_dir: object = None                      # not ported yet: raises

    def __post_init__(self):
        if self.aot_dir:
            raise NotImplementedError(
                "PoolConfig.aot_dir (the AOT store) is not ported yet "
                "(ROADMAP Queue 1 item 5g)")
        if self.deadline_s <= self.heartbeat_s:
            raise MXNetError(
                f"pool deadline_s ({self.deadline_s:g}) must exceed "
                f"heartbeat_s ({self.heartbeat_s:g}) — a deadline inside "
                "one heartbeat interval declares healthy replicas dead")
        if self.surge < 1:
            raise MXNetError("pool surge must be >= 1")


@dataclass
class ReplicaState:
    """One ledger-derived row of :meth:`ReplicaPool.view` — everything
    the router is allowed to know about a replica."""

    id: str
    alive: bool
    ready: bool
    draining: bool = False
    queue_depth: int = 0
    params_step: object = None
    last_batch_age_s: object = None
    port: object = None
    pid: object = None
    idle_s: float = 0.0
    # served-tenant advertisement from a fleet replica's beacon:
    # {tenant: {"state": admitted|half_open|quarantined, "step": N}};
    # None = single-tenant replica (tenant-agnostic placement)
    tenants: object = None


def _wait_for(predicate, deadline_s, poll_s=0.05, what="condition"):
    """Bounded poll: True when ``predicate()`` held before the deadline,
    else False (callers decide whether that is fatal)."""
    deadline = time.monotonic() + max(float(deadline_s), 0.0)
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return bool(predicate())


class LocalReplica:
    """In-process replica: a :class:`~.server.Server` built by
    ``factory()`` plus its own beacon thread.  The cheap unit for router
    logic tests and single-process deployments — same ledger contract
    as a subprocess worker, minus the process isolation."""

    kind = "local"

    def __init__(self, rid, factory, hb_dir, config):
        self.id = str(rid)
        self.factory = factory
        self.cfg = config
        self.server = None
        self._draining = False
        self._pin = None               # deploy pin; survives restart()
        self._hb = Heartbeat(hb_dir, self.id, config.heartbeat_s,
                             payload=self._beacon, prefix="replica")

    def _beacon(self):
        srv = self.server
        if srv is None:
            return {"ready": False, "draining": self._draining}
        doc = srv.beacon()
        doc["draining"] = self._draining
        doc["ready"] = bool(doc["ready"]) and not self._draining
        return doc

    def start(self):
        if self.server is None:
            self.server = self.factory()
        if self._pin is not None:
            # pin BEFORE start: the initial force-reload then lands on
            # the pinned step, not the newest committed one
            self.server.pin_params(self._pin)
        self.server.start()
        self._draining = False
        self._hb.start()
        return self

    def pin(self, step):
        """Pin (or with None unpin) this replica's ParamStore to one
        step.  The pin is remembered on the HANDLE too, so a later
        ``restart()``'s fresh factory build starts pinned — a respawned
        canary/rolled-back replica cannot drift off its assigned
        version.  Returns True when a live server took the pin now."""
        self._pin = None if step is None else int(step)
        srv = self.server
        if srv is None:
            return False
        return bool(srv.pin_params(self._pin))

    def predict(self, x, deadline_ms, cancel=None, tenant=None):
        """One attempt on this replica; returns ``(array, meta)`` or
        raises a structured serving error."""
        srv = self.server
        if srv is None:
            raise ReplicaUnavailable(self.id, "not started")
        budget_s = (deadline_ms / 1000.0 if deadline_ms
                    else srv.config.result_timeout_s)
        resp = srv.submit(x, deadline_ms=deadline_ms, cancel=cancel,
                          tenant=tenant)
        value = resp.result(timeout_s=budget_s + 5.0)
        return value, {"replica": self.id,
                       "params_step": resp.params_step}

    def decode(self, tokens, max_new_tokens=None, deadline_ms=None,
               cancel=None, tenant=None):
        """One decode attempt on this replica's continuous batcher;
        returns ``(token list, meta)`` or raises a structured serving
        error (``SlotsExhausted`` → the router tries another replica)."""
        srv = self.server
        if srv is None:
            raise ReplicaUnavailable(self.id, "not started")
        budget_s = (deadline_ms / 1000.0 if deadline_ms
                    else srv.config.result_timeout_s)
        stream = srv.decode_submit(tokens, max_new_tokens=max_new_tokens,
                                   deadline_ms=deadline_ms, tenant=tenant)
        if cancel is not None and cancel.is_set():
            stream.cancel()
        toks = stream.result(timeout_s=budget_s + 5.0)
        return toks, {"replica": self.id, "generated": len(toks)}

    def drain(self, deadline_s) -> int:
        self._draining = True
        self._hb.beat()                    # publish not-ready immediately
        srv = self.server
        if srv is None:
            return 0
        _wait_for(lambda: srv.queue_depth() == 0, deadline_s,
                  self.cfg.poll_s)
        return srv.queue_depth()

    def restart(self, deadline_s=None):
        """Replace the server with a fresh ``factory()`` build — which
        re-reads the newest valid committed step from its ParamStore at
        ``start()`` (the upgrade path).  ``deadline_s`` bounds the old
        server's stop."""
        if self.server is not None:
            self.server.stop(timeout_s=30.0 if deadline_s is None
                             else max(float(deadline_s), 1.0))
        self.server = self.factory()
        if self._pin is not None:
            self.server.pin_params(self._pin)
        self.server.start()
        self._draining = False
        # a replica whose beacon daemon died with it (kill() stops the
        # heartbeat thread without resigning, the host-vanished shape)
        # must come back BEATING, or
        # the monitor re-detects it as lost every deadline and burns the
        # crash-loop budget on a healthy server; start() is a no-op when
        # the daemon is still running and beats once either way
        self._hb.start()
        self._hb.beat()

    def stop(self):
        if self.server is not None:
            self.server.stop(timeout_s=30.0)
        self._hb.stop(resign=True)

    def kill(self):
        """In-process stand-in for the host-vanished shape (a process
        kill on a local pool): the beacon daemon
        stops WITHOUT resigning — the seq file goes stale exactly as a
        SIGKILLed worker's would — and the server handle is torn away so
        dispatches fail structured (``ReplicaUnavailable``).  The pool
        monitor must detect, journal ``replica_lost`` and restart it
        with zero cooperation from this handle.  The orphaned server
        winds down on a background thread: a kill must not block the
        killer, and in-flight requests fail over like the process died."""
        self._hb.stop(resign=False)
        srv, self.server = self.server, None
        if srv is not None:
            threading.Thread(target=lambda: srv.stop(timeout_s=5.0),
                             daemon=True,
                             name=f"mxnet-torch-kill-{self.id}").start()

    def pid(self):
        return os.getpid()


class ProcReplica:
    """Subprocess replica: ``python -m mxnet_tpu_torch.serving worker``
    with its own device context, queue, cache, and ParamStore — the unit
    a SIGKILL takes down.  Discovery is ledger-only: the worker publishes
    its bound port in the heartbeat beacon; this handle reads it back
    through the pool's :class:`LivenessReader` (``port_of``)."""

    kind = "proc"

    def __init__(self, rid, worker_args, hb_dir, config, port_of,
                 env=None):
        self.id = str(rid)
        self.worker_args = dict(worker_args)   # CLI flag -> value
        self.hb_dir = hb_dir
        self.cfg = config
        self.port_of = port_of                 # rid -> beacon port | None
        self.env = env
        self.proc = None

    def _argv(self):
        argv = [sys.executable, "-m", "mxnet_tpu_torch.serving", "worker",
                "--replica-id", self.id, "--hb-dir", self.hb_dir,
                "--heartbeat-s", str(self.cfg.heartbeat_s)]
        for flag, value in sorted(self.worker_args.items()):
            if value is not None:
                argv += [flag, str(value)]
        return argv

    def start(self):
        if self.proc is not None and self.proc.poll() is None:
            return self
        self.proc = subprocess.Popen(self._argv(), env=self.env)
        get_journal().event("pool_spawn", replica=self.id,
                            pid=self.proc.pid)
        return self

    # -- wire client -----------------------------------------------------
    def _roundtrip(self, header, payload=b"", budget_s=10.0):
        port = self.port_of(self.id)
        if port is None:
            raise ReplicaUnavailable(self.id, "no port in beacon yet")
        try:
            # fault seams: ``wire_connect`` at the socket open,
            # ``wire_send`` before the frame; both carry the replica id
            _atomic.trip("wire_connect", self.id)
            with socket.create_connection(
                    ("127.0.0.1", int(port)),
                    timeout=min(budget_s, 5.0)) as s:
                s.settimeout(budget_s + 5.0)
                _atomic.trip("wire_send", self.id)
                wire.send_frame(s, header, payload)
                return wire.recv_frame(s)
        except (OSError, wire.WireError) as e:
            raise ReplicaUnavailable(
                self.id, f"{type(e).__name__}: {e}") from None

    @staticmethod
    def _raise_remote(header):
        name = header.get("error", "RequestError")
        detail = header.get("detail", "")
        tenant = header.get("tenant")
        if name == "DeadlineExceeded":
            raise DeadlineExceeded(header.get("stage", "remote"),
                                   float(header.get("late_ms", 0.0)),
                                   tenant=tenant)
        if name == "ServerOverloaded":
            raise ServerOverloaded(header.get("depth", -1),
                                   header.get("limit", -1),
                                   tier=header.get("tier"),
                                   tenant=tenant)
        if name == "ServerStopped":
            raise ServerStopped(detail or "replica stopped")
        if name == "SlotsExhausted":
            raise SlotsExhausted(header.get("slots", -1),
                                 queued=header.get("queued", 0),
                                 tenant=tenant)
        if name == "TenantQuarantined":
            from .fleet import TenantQuarantined
            err = TenantQuarantined(tenant,
                                    header.get("reason", detail or
                                               "remote quarantine"))
            # the wire's verdict: a half-open probe slot that is busy is
            # retryable on another replica, a real quarantine is not
            err.retryable = bool(header.get("retryable", False))
            raise err
        err = RequestError(f"{name}: {detail}")
        err.retryable = bool(header.get("retryable", True))
        err.tenant = tenant
        raise err

    def predict(self, x, deadline_ms, cancel=None, tenant=None):
        # `cancel` has no remote lever: a losing hedge's reply is simply
        # discarded by the router (in-process replicas do cancel at
        # dequeue)
        x = np.ascontiguousarray(x)
        budget_s = deadline_ms / 1000.0 if deadline_ms else 60.0
        header = {"cmd": "predict", "shape": list(x.shape),
                  "dtype": str(x.dtype), "deadline_ms": deadline_ms}
        if tenant is not None:
            header["tenant"] = str(tenant)
        # the router's trace context crosses the process boundary: the
        # worker re-anchors its serving_request root under these ids
        wire.attach_trace(header)
        header, payload = self._roundtrip(
            header, x.tobytes(), budget_s=budget_s)
        if not header.get("ok"):
            self._raise_remote(header)
        out = np.frombuffer(payload, dtype=header["dtype"]).reshape(
            header["shape"])
        return out, {"replica": self.id,
                     "params_step": header.get("params_step")}

    def decode(self, tokens, max_new_tokens=None, deadline_ms=None,
               cancel=None, tenant=None):
        """One remote decode attempt: the prompt ships as int32 payload
        bytes, the generated tokens come back the same way.  ``cancel``
        has no remote lever mid-stream (same asymmetry as predict
        hedging) — the router simply discards a stale reply."""
        arr = np.ascontiguousarray(
            np.asarray(tokens, dtype=np.int32).reshape(-1))
        budget_s = deadline_ms / 1000.0 if deadline_ms else 60.0
        header = {"cmd": "decode", "count": int(arr.size),
                  "deadline_ms": deadline_ms}
        if max_new_tokens is not None:
            header["max_new"] = int(max_new_tokens)
        if tenant is not None:
            header["tenant"] = str(tenant)
        wire.attach_trace(header)
        header, payload = self._roundtrip(
            header, arr.tobytes(), budget_s=budget_s)
        if not header.get("ok"):
            self._raise_remote(header)
        out = np.frombuffer(payload, dtype=np.int32).tolist()
        return out, {"replica": self.id, "generated": len(out)}

    def drain(self, deadline_s) -> int:
        try:
            header, _ = self._roundtrip(
                {"cmd": "drain", "deadline_s": deadline_s},
                budget_s=float(deadline_s) + 5.0)
        except ReplicaUnavailable:
            return 0                   # already gone: nothing to drain
        return int(header.get("residual", 0))

    def pin(self, step):
        """Pin (or with None unpin) the worker's ParamStore to one step.
        Two levers, both needed: a ``pin`` wire frame moves the LIVE
        worker now, and ``--pin-step`` in ``worker_args`` makes the next
        (re)spawn start pinned — a canary respawned by the monitor
        mid-deploy must come back on its assigned version, not the
        newest root.  Returns True when the live worker acked."""
        if step is None:
            self.worker_args.pop("--pin-step", None)
        else:
            self.worker_args["--pin-step"] = int(step)
        try:
            header, _ = self._roundtrip(
                {"cmd": "pin",
                 "step": None if step is None else int(step)},
                budget_s=10.0)
        except ReplicaUnavailable:
            return False               # not up: the arg pins the spawn
        return bool(header.get("ok")) and bool(header.get("pinned"))

    def restart(self, deadline_s=None):
        """Stop (graceful ``stop`` frame, then terminate/kill fallback)
        and spawn a fresh worker — which reads the newest CRC-valid
        committed step at startup.  ``deadline_s`` bounds the whole
        stop ladder; without one the 5/15/10/10 ladder applies."""
        proc = self.proc
        if proc is not None and proc.poll() is None:
            deadline = None if deadline_s is None \
                else time.monotonic() + max(float(deadline_s), 1.0)

            def budget(default):
                if deadline is None:
                    return default
                return max(min(default, deadline - time.monotonic()), 1.0)

            try:
                self._roundtrip({"cmd": "stop"}, budget_s=budget(5.0))
            except ReplicaUnavailable:
                pass
            try:
                proc.wait(timeout=budget(15.0))
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=budget(10.0))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=budget(10.0))
        self.proc = None
        self.start()

    def stop(self):
        proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                self._roundtrip({"cmd": "stop"}, budget_s=5.0)
            except ReplicaUnavailable:
                pass
            try:
                proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    pass
        self.proc = None

    def kill(self):
        """SIGKILL the worker ("host vanished"): no
        handlers, no drain, no beacon resignation."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def pid(self):
        return None if self.proc is None else self.proc.pid


class ReplicaPool:
    """Owns N replicas and the health ledger under ``root/hb``.

    Router-facing surface: :meth:`view` (ledger-derived states) and
    :attr:`replicas` (id → handle, for dispatch).  Operator surface:
    ``start/stop``, ``drain``, ``restart``, rolling ``reload``, and the
    auto-respawn ``monitor``."""

    def __init__(self, root, config=None):
        self.root = str(root)
        self.cfg = config or PoolConfig()
        self.hb_dir = os.path.join(self.root, "hb")
        os.makedirs(self.hb_dir, exist_ok=True)
        # pod run id: one identity every subprocess replica inherits, so
        # its records are attributable; adopt the ambient id when a
        # launcher already published one
        self.run_id = os.environ.get("MXNET_TPU_POD_RUN_ID") or \
            f"pod-{os.urandom(4).hex()}"
        # published in this process too (trace.identity() reads the
        # environment), and a journal-mode tracer configured before the
        # pool anchors again so its records carry the id (the newest
        # anchor wins in the aggregator; same epoch, same alignment)
        if "MXNET_TPU_POD_RUN_ID" not in os.environ:
            os.environ["MXNET_TPU_POD_RUN_ID"] = self.run_id
            from ..observability import trace as _trace
            tracer = _trace.get_tracer()
            if tracer.mode == "journal":
                tracer.journal_anchor()
        self.reader = LivenessReader(self.hb_dir, self.cfg.deadline_s,
                                     prefix="replica")
        self.replicas: dict = {}
        self._respawns: dict = {}
        self._last_respawn: dict = {}      # rid -> monotonic spawn time
        # short-TTL view cache: the ledger only changes at heartbeat
        # granularity, so per-request re-reads of N beacon files are
        # pure I/O waste on the router's hot path; a quarter-heartbeat
        # snapshot preserves the uniform-view contract
        self._view_ttl_s = self.cfg.heartbeat_s / 4.0
        self._view_cache = (None, 0.0)     # (states, monotonic stamp)
        self._monitor_stop = threading.Event()
        self._monitor = None
        self._lock = threading.Lock()      # lifecycle ops serialize
        self._deploy_owner = None          # guarded by _lock; set while a
                                           # DeployController owns the pool

    # -- construction ----------------------------------------------------
    def add_local(self, rid, factory) -> "ReplicaPool":
        """Add an in-process replica built by ``factory() -> Server``."""
        # construction-phase single writer: add_* run before start()/
        # monitor_start() spawn any thread that could observe the dict
        self.replicas[str(rid)] = LocalReplica(rid, factory, self.hb_dir,
                                               self.cfg)
        return self

    def add_proc(self, rid, worker_args, env=None) -> "ReplicaPool":
        """Add a subprocess replica (``worker_args``: CLI flag → value,
        e.g. ``{"--model": "mlp", "--ckpt-root": root}``).  The worker
        inherits the pod run id and its replica identity through the
        environment and, when the pool has a ``trace_dir``, its own
        journal and flight-recorder sinks there."""
        rid = str(rid)
        # an env built as {**os.environ, ...} inherits the ambient
        # MXNET_TPU_TRACE: only a value that differs from it is the
        # caller's deliberate choice for this worker
        caller_trace = (env is not None and "MXNET_TPU_TRACE" in env
                        and env["MXNET_TPU_TRACE"]
                        != os.environ.get("MXNET_TPU_TRACE"))
        env = dict(os.environ if env is None else env)
        env.setdefault("MXNET_TPU_POD_RUN_ID", self.run_id)
        env["MXNET_TPU_REPLICA_ID"] = rid
        trace_dir = self.cfg.trace_dir
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            # one journal per process is what the aggregator assembles:
            # a shared file would interleave the timelines
            env["MXNET_TPU_TRACE_DIR"] = str(trace_dir)
            env["MXNET_TPU_JOURNAL"] = os.path.join(
                str(trace_dir), f"journal-{rid}.jsonl")
            # journal mode over any ambient mode, or the worker's
            # journal would hold no spans
            if not caller_trace:
                env["MXNET_TPU_TRACE"] = "journal"
        # construction-phase single writer (see add_local)
        self.replicas[rid] = ProcReplica(
            rid, worker_args, self.hb_dir, self.cfg,
            self._port_of, env=env)
        return self

    def _port_of(self, rid):
        self.reader.observe(rid)
        doc = self.reader.payload(rid)
        return None if doc is None else doc.get("port")

    # -- the ledger view (the router's ONLY health source) ---------------
    def view(self) -> list:
        """One :class:`ReplicaState` per configured replica, derived
        entirely from the heartbeat ledger — uniform across every
        reader of the same ledger.  Snapshots are cached for a quarter
        heartbeat (the ledger's own update granularity); callers must
        not mutate the returned states."""
        cached, stamp = self._view_cache
        now = time.monotonic()
        if cached is not None and now - stamp < self._view_ttl_s:
            return cached
        out = []
        for rid in self.replicas:
            idle = self.reader.observe(rid)
            alive = idle is not None and idle <= self.cfg.deadline_s
            doc = self.reader.payload(rid) or {}
            out.append(ReplicaState(
                id=rid, alive=alive,
                ready=alive and bool(doc.get("ready")),
                draining=bool(doc.get("draining")),
                queue_depth=int(doc.get("queue_depth") or 0),
                params_step=doc.get("params_step"),
                last_batch_age_s=doc.get("last_batch_age_s"),
                port=doc.get("port"), pid=doc.get("pid"),
                idle_s=round(idle or 0.0, 3),
                tenants=doc.get("tenants")))
        self._view_cache = (out, now)
        return out

    def wait_ready(self, rids=None, deadline_s=None) -> bool:
        rids = set(map(str, rids)) if rids is not None \
            else set(self.replicas)
        deadline_s = self.cfg.spawn_s if deadline_s is None else deadline_s

        def _all_ready():
            return all(s.ready for s in self.view() if s.id in rids)

        return _wait_for(_all_ready, deadline_s, self.cfg.poll_s)

    # -- lifecycle -------------------------------------------------------
    def start(self, wait_ready=True) -> "ReplicaPool":
        get_journal().event("pool_start", root=self.root,
                            replicas=sorted(self.replicas),
                            heartbeat_s=self.cfg.heartbeat_s,
                            deadline_s=self.cfg.deadline_s,
                            run_id=self.run_id,
                            trace_dir=self.cfg.trace_dir)
        for rep in self.replicas.values():
            rep.start()
        if wait_ready and not self.wait_ready():
            laggards = [s.id for s in self.view() if not s.ready]
            raise MXNetError(
                f"replica pool did not become ready within "
                f"{self.cfg.spawn_s:g}s (not ready: {laggards}) — see "
                "the journal / worker stderr")
        return self

    def stop(self) -> None:
        self.monitor_stop()
        for rep in self.replicas.values():
            rep.stop()
        get_journal().event("pool_stop", root=self.root)

    def drain(self, rid, deadline_s=None) -> int:
        """Stop admission on one replica (the beacon flips not-ready so
        the router routes around it), then let its queue empty under a
        bounded deadline.  Returns the residual depth (0 = clean)."""
        rid = str(rid)
        deadline_s = self.cfg.drain_s if deadline_s is None else deadline_s
        with self._lock:
            residual = self.replicas[rid].drain(deadline_s)
        get_journal().event("pool_drain", replica=rid,
                            deadline_s=deadline_s, residual=residual)
        return residual

    def restart(self, rid, deadline_s=None, drain=True) -> None:
        """Draining restart: drain (bounded), replace the worker, wait
        ready.  The fresh worker loads the newest CRC-valid committed
        step from its checkpoint root — restart IS the upgrade path."""
        rid = str(rid)
        residual = self.drain(rid, deadline_s) if drain else None
        # an intentional restart resigns the beacon before the fresh
        # worker's first beat — give the monitor the same startup grace
        # as its own respawns, or it races this restart with another
        self._last_respawn[rid] = time.monotonic()
        with self._lock:
            self.replicas[rid].restart(deadline_s=deadline_s)
        # read the ledger as it is now: a view cached before the drain
        # still shows this replica ready on its old step (the reference
        # waits on that snapshot when a restart takes less than a quarter
        # heartbeat, and reload() then reports the old step)
        self._view_cache = (None, 0.0)
        ready = self.wait_ready([rid])
        get_journal().event("pool_restart", replica=rid,
                            residual=residual, ready=ready)
        if not ready:
            raise MXNetError(f"replica {rid!r} did not come back ready "
                             f"within {self.cfg.spawn_s:g}s after restart")

    # -- deploy ownership (serving/deploy.py) ---------------------------
    def deploy_acquire(self, owner) -> None:
        """Claim exclusive fleet-version ownership for a deployment.
        Raises :class:`DeployInProgress` when another deploy holds it —
        refused, not queued (two rollouts would tear old-xor-new)."""
        owner = str(owner)
        with self._lock:
            holder = self._deploy_owner
            if holder is None:
                self._deploy_owner = owner
        if holder is not None:
            raise DeployInProgress(holder, "deploy")

    def deploy_release(self, owner) -> None:
        """Release deploy ownership (idempotent; only the holder's tag
        releases)."""
        with self._lock:
            if self._deploy_owner == str(owner):
                self._deploy_owner = None

    def deploy_owner(self):
        with self._lock:
            return self._deploy_owner

    def pin_step(self, rid, step) -> bool:
        """Pin one replica to ``step`` (None unpins) through its handle
        — live store pin for in-process replicas, wire frame + respawn
        arg for subprocess workers.  Journaled so the deploy trail shows
        which replica was held on which version."""
        rid = str(rid)
        with self._lock:
            took = self.replicas[rid].pin(step)
        get_journal().event("pool_pin", replica=rid, step=step,
                            live=bool(took))
        return bool(took)

    def reload(self, surge=None, deadline_s=None) -> dict:
        """Rolling fleet upgrade: drain + restart every replica, at most
        ``surge`` out of rotation at a time, each restart landing on the
        newest CRC-valid committed step at ITS restart moment (a step
        published mid-roll splits the fleet across exactly the old and
        the new root — never a torn state).  Refused with
        :class:`DeployInProgress` while a canary deployment owns the
        pool.  Returns the post-roll ``{replica: params_step}`` map."""
        with self._lock:
            holder = self._deploy_owner
        if holder is not None:
            raise DeployInProgress(holder, "reload")
        surge = self.cfg.surge if surge is None else max(int(surge), 1)
        rids = sorted(self.replicas)
        get_journal().event("pool_reload", phase="begin", surge=surge,
                            replicas=rids)
        for i in range(0, len(rids), surge):
            wave = rids[i:i + surge]
            for rid in wave:
                self.restart(rid, deadline_s=deadline_s)
        steps = {s.id: s.params_step for s in self.view()}
        get_journal().event("pool_reload", phase="end", steps=steps)
        return steps

    # -- auto-respawn monitor -------------------------------------------
    def monitor_start(self, interval_s=None) -> None:
        """Watch the ledger; a replica whose heartbeat stalls past the
        deadline is journaled ``replica_lost`` and respawned (bounded by
        the per-replica crash-loop budget)."""
        if self._monitor is not None:
            return
        interval = self.cfg.monitor_s if interval_s is None else interval_s
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_run, args=(interval,), daemon=True,
            name="mxnet-torch-pool-monitor")
        self._monitor.start()

    def monitor_stop(self) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=self.cfg.monitor_s + 5.0)
            self._monitor = None

    def _monitor_run(self, interval):
        while not self._monitor_stop.wait(interval):
            try:
                self._sweep_dead()
            except Exception as exc:       # the monitor must outlive one
                get_journal().crash(exc, where="pool_monitor")

    def _sweep_dead(self):
        now = time.monotonic()
        for state in self.view():
            if state.alive:
                continue
            # a just-respawned worker needs its startup window before
            # its first heartbeat can land — don't double-respawn it
            t = self._last_respawn.get(state.id)
            if t is not None and now - t < self.cfg.spawn_s:
                continue
            rep = self.replicas[state.id]
            proc_gone = rep.kind == "proc" and (
                rep.proc is None or rep.proc.poll() is not None)
            n = self._respawns.get(state.id, 0)
            get_journal().event("replica_lost", replica=state.id,
                                idle_s=state.idle_s, pid=state.pid,
                                proc_exited=proc_gone, respawns=n)
            if n >= self.cfg.max_respawns:
                get_journal().event("replica_respawn_exhausted",
                                    replica=state.id, respawns=n)
                self._last_respawn[state.id] = now   # re-log per window
                continue
            self._respawns[state.id] = n + 1
            self._last_respawn[state.id] = now
            with self._lock:
                rep.restart()
