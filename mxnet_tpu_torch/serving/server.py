"""The serving core: admission → dynamic batching → predictors
(counterpart of ``mxnet_tpu/serving/server.py``).

One worker thread owns the device: callers enqueue single samples into a
**bounded** queue (admission control — a full queue sheds with
:class:`~.batcher.ServerOverloaded` instead of growing latency), the
worker coalesces same-bucket requests under a window, pads them to the
bucket grid and runs the block once per batch through the bounded
:class:`~.cache.PredictorCache`. Per-request deadlines are checked at
dequeue and after the batch.

The server runs on ``cuda:0`` unless it is given ``ctx=cpu()``; without
a CUDA device and without that request it raises at construction. On
the card each predictor is a CUDA graph of one padded shape, captured
when the predictor is built: ``start()`` builds every batch bucket x
feature shape of ``config.aot_prewarm`` before admitting traffic
(:meth:`Server.prewarm`), and any other shape is captured at its first
batch. A capture that fails fails that batch's requests.

Parameters hot-reload between batches from the newest valid committed
checkpoint step (``param_store=``, a :class:`~.reload.ParamStore`). The
step is validated and read on a loader thread while the worker serves
the old weights (the reference loads on the worker, which then answers
nothing for the whole load); at its first turn after the load the
worker checks the whole checkpoint against the live parameters' names
and shapes (architecture drift is refused with nothing applied) and
copies it into the live tensors in place, so the captured graphs replay
the new weights without a capture. Every response carries the step that
served it (``params_step``); ``pin_params(step)`` pins the store and
moves the live step there (a rollback included) the same way. The
journal gets ``serving_reload`` / ``serving_reload_failed``.

A ``decode_model`` (``ServerConfig.decode_model``, a
:class:`~.decode.DecodeModel`) adds the continuous-batching decode
engine beside the one-shot worker: ``start()`` builds its whole program
set after the predictors' prewarm and before the worker thread starts,
``stop()`` stops it first, and ``decode_submit``/``decode`` admit
streams. ``submit(cancel=)`` takes the hedging router's cancel event: a
request whose event is set is dropped at dequeue with
``RequestCancelled``. ``beacon()`` is the replica pool's readiness
payload.

Tracing (``observability.trace``): each request owns a
``serving_request`` root span, opened at ``submit`` (under ``parent=``,
the wire frame's context, when a worker admits it) and closed with its
status by whichever thread resolves it, with an ``enqueue`` event, an
``execute`` span and a ``respond`` event under it. Each batch is a
``serving_batch`` span that lists its requests' spans, and a predictor
build is an ``xla_compile`` span (site ``serving_predictor``; a
CUDA-graph capture on the card). ``execute`` begins where ``exec_ms``
does and ends after the predictor has copied the outputs to the host,
so it covers the card's time. Every batch journals a ``serving_batch``
record; :meth:`Server.metrics_text` renders the counters as Prometheus
text.

The tenant and execution hooks (``_admit_tenant`` … ``_batch_succeeded``)
are the reference's: a single-tenant Server refuses a tenant and runs
its one block; :class:`~.fleet.Fleet` overrides them with its tenant
registry, per-tenant breakers and weight paging.

Not ported yet: the AOT cache's on-disk store (a CUDA graph cannot be
serialized), shard plans (ROADMAP Queue 1 item 9), tuned tables, device
retries and the ``MXNET_TPU_SERVING_*`` environment defaults (item 5f).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from ..base import MXNetError
from ..context import resolve_device
from ..diagnostics.journal import get_journal
from ..metric import LatencySummary
from ..observability import instrument as _obs
from ..observability import trace as _trace
from ..resilience import atomic as _atomic
from .batcher import (DeadlineExceeded, PendingResponse, Request,
                      RequestCancelled, RequestError, ServerOverloaded,
                      ServerStopped, drop_expired, take_batch)
from .buckets import BucketGrid
from .cache import Predictor, PredictorCache

__all__ = ["Server", "ServerConfig"]

_STOP = object()
_server_seq = itertools.count()


def _req_ids(req) -> dict:
    """trace_id/span_id of a request's root span for explicit journal
    correlation (the root is started by hand at submit, so the journal's
    provider cannot see it); {} with tracing off."""
    sp = req.trace
    if sp is None or sp.trace_id is None:
        return {}
    return {"trace_id": sp.trace_id, "span_id": sp.span_id}


def _end_span(req, status):
    """Close a request's root span (idempotent; None-safe)."""
    if req.trace is not None:
        req.trace.end(status=status)


@dataclass
class ServerConfig:
    """Serving knobs, with the JAX package's defaults."""

    max_batch: int = 8                       # largest coalesced batch
    batch_buckets: tuple | None = None       # default: powers of 2
    dim_buckets: dict | None = None          # {feature axis: sizes}
    max_queue: int = 128
    window_ms: float = 5.0
    default_deadline_ms: float = 2000.0
    cache_entries: int = 16
    reload_poll_s: float = 10.0              # < 0: poll only at start()
    aot_prewarm: tuple | None = None         # feature shapes warmed at start
    idle_poll_s: float = 0.05                # worker wake granularity
    dtype: str = "float32"                   # request payload dtype
    pad_value: float = 0.0
    crop_outputs: bool = True                # unpad outputs that kept dims
    result_timeout_s: float = 60.0           # PendingResponse default wait
    # continuous-batching decode (serving/decode.py): a DecodeModel served
    # beside the one-shot batcher, its knobs in ``decode`` (a DecodeConfig;
    # None = the MXNET_TPU_DECODE_* defaults)
    decode_model: object = None
    decode: object = None

    def summary(self) -> dict:
        return {"max_batch": self.max_batch, "max_queue": self.max_queue,
                "window_ms": self.window_ms,
                "default_deadline_ms": self.default_deadline_ms,
                "cache_entries": self.cache_entries,
                "reload_poll_s": self.reload_poll_s, "dtype": self.dtype,
                "aot_dir": None,
                "decode": None if self.decode_model is None
                else type(self.decode_model).__name__,
                "shard_plan": None}


def _check_device(block, device):
    """Raise unless every materialized parameter of ``block`` lives on
    ``device``."""
    for name, t in block.state_dict(keep_vars=True).items():
        if not is_lazy(t) and t.device != device:
            raise MXNetError(f"parameter {name} is on {t.device}; the "
                             f"server runs on {device}")


class Server:
    """Dynamic-batching inference server around one initialized Block.

    ``ctx`` picks the device (default ``cuda:0``); the block's
    parameters must already live there (``initialize(ctx=...)`` or a
    load onto it). ``param_store`` (a :class:`~.reload.ParamStore`)
    enables hot reload. ``block=None`` is for a subclass that brings its
    own blocks (:class:`~.fleet.Fleet`)."""

    def __init__(self, block, config=None, param_store=None, ctx=None):
        self.block = block
        self.config = cfg = config or ServerConfig()
        self.device = resolve_device(ctx)
        if block is not None:
            _check_device(block, self.device)
        self.grid = BucketGrid(cfg.max_batch, cfg.batch_buckets,
                               cfg.dim_buckets)
        self.cache = PredictorCache(cfg.cache_entries)
        self.param_store = param_store
        self.latency = LatencySummary("request_latency_ms")
        self.exec_ms = LatencySummary("exec_ms")   # per batch: predictor
        self._dtype = np.dtype(cfg.dtype)
        self._queue = queue.Queue(maxsize=cfg.max_queue)
        self._worker = None
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        # admission gate: submit's closed-check + enqueue and stop's
        # close + straggler sweep serialize on this lock, so a request
        # can never slip into the queue after the final sweep
        self._admit_lock = threading.Lock()
        self._closed = False
        self._ctx = ctx
        self._params_step = None
        self._last_reload_check = None
        self._pin_dirty = False        # guarded by _lock; set by pin_params
                                       # (controller thread), consumed by the
                                       # worker thread in _maybe_reload
        self._loader = None            # the reload's load thread
        self._reload_job = None        # (target step, future) of the load
                                       # in flight; worker thread only
        self._last_batch_t = None
        self.last_prewarm = None
        self._metrics_httpd = None
        self._metrics_id = f"srv{next(_server_seq)}"
        # the continuous batcher: its own worker thread and slot pool,
        # started and stopped with this server, on its device
        self.decoder = None
        if cfg.decode_model is not None:
            from .decode import DecodeConfig, DecodeEngine
            self.decoder = DecodeEngine(cfg.decode_model,
                                        cfg.decode or DecodeConfig(),
                                        ctx=self.device)
        self.counters = {"accepted": 0, "served": 0, "shed": 0,
                         "rejected_shape": 0, "rejected_stopped": 0,
                         "cancelled": 0, "deadline_miss_dequeue": 0,
                         "deadline_miss_post_batch": 0, "errors": 0,
                         "reloads": 0, "batches": 0}

    # -- deployment-pair constructor ------------------------------------------
    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_names=("data",),
                        config=None, param_store=None, ctx=None):
        """Serve a ``prefix-symbol.json`` + ``prefix-NNNN.params`` pair
        (``HybridBlock.export`` / ``model.save_checkpoint`` files of
        either package) through ``SymbolBlock.imports`` onto ``ctx``
        (``cuda:0`` unless the caller asks for the CPU), behind the same
        batching front end (ref: the JAX package's
        ``Server.from_checkpoint``)."""
        from ..gluon.block import SymbolBlock
        block = SymbolBlock.imports(
            f"{prefix}-symbol.json", list(input_names),
            f"{prefix}-{epoch:04d}.params", ctx=ctx)
        return cls(block, config=config, param_store=param_store, ctx=ctx)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stopping.clear()
        with self._admit_lock:
            self._closed = False
        self._maybe_reload(force=True)     # begin on the newest valid step
        if self.config.aot_prewarm:
            self.prewarm()                 # the lattice before traffic
        if self.decoder is not None:
            # every decode program before traffic: a build mid-decode is
            # a defect, not a cold start
            self.decoder.start()
            self.decoder.warmup()
        if self.param_store is not None:
            self._loader = ThreadPoolExecutor(
                1, thread_name_prefix="mxnet-torch-serving-reload")
        self._worker = threading.Thread(
            target=self._run, name="mxnet-torch-serving-worker", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout_s=30.0, drain=True):
        """Shut down: with ``drain`` the worker finishes everything
        admitted before the sentinel; without, pending requests fail
        with :class:`ServerStopped`. Admission closes first, so a racing
        submit is either served or failed structurally, never dropped.
        The join is bounded by ``timeout_s``."""
        if self._worker is None:
            return
        if self._metrics_httpd is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
            self._metrics_httpd = None
        if self.decoder is not None:
            self.decoder.stop(timeout_s=timeout_s, drain=drain)
        with self._admit_lock:
            self._closed = True
        if not drain:
            self._stopping.set()
        try:
            self._queue.put(_STOP, timeout=timeout_s)
        except queue.Full:
            self._stopping.set()           # flooded: stop without drain
        self._worker.join(timeout=timeout_s)
        if self._worker.is_alive():
            raise MXNetError(f"serving worker did not stop within "
                             f"{timeout_s:g}s (device wedged mid-batch?)")
        stragglers: list = []
        with self._admit_lock:
            self._drain_queue(stragglers)
        self._fail_remaining(stragglers)
        self._worker = None
        if self._loader is not None:
            self._loader.shutdown(wait=True)
            self._loader = None
        if self._reload_job is not None:
            # loaded, never applied: the store must offer it again
            self._reload_job = None
            self.param_store.loaded_step = self._params_step
            with self._lock:
                self._pin_dirty = self.param_store.pinned_step is not None

    # -- bucket-lattice prewarm ----------------------------------------------
    def prewarm(self, shapes=None) -> dict:
        """Build the predictor of every batch bucket x feature shape ahead
        of traffic (ref: Server.prewarm). ``shapes``: per-request feature
        shapes, no batch axis (default ``config.aot_prewarm``). Returns
        ``{warmed, loaded, compiled, skipped, ms}`` with the reference's
        keys: ``warmed`` predictors built, ``loaded`` 0 (no graph is read
        from disk), ``compiled`` the CUDA graphs captured (0 on the CPU,
        where a predictor runs eagerly), ``skipped`` the shapes outside
        the grid. A failed capture raises."""
        shapes = shapes if shapes is not None else self.config.aot_prewarm
        t0 = time.perf_counter()
        warmed = 0
        skipped = []
        for shape in shapes or ():
            key = self.grid.feature_key(tuple(shape))
            if key is None:
                skipped.append(list(shape))    # outside the grid
                continue
            for bucket in self.grid.batch_buckets:
                _, hit = self.cache.get(
                    (bucket, key, self._dtype.str),
                    lambda b=bucket, k=key: self._build_ready_predictor(
                        self.block, b, k))
                warmed += not hit
        compiled = warmed if self.device.type == "cuda" else 0
        out = {"warmed": warmed, "loaded": 0, "compiled": compiled,
               "skipped": skipped,
               "ms": round((time.perf_counter() - t0) * 1000.0, 2)}
        self.last_prewarm = out
        return out

    def _build_predictor(self, block, bucket, key):
        """One predictor of ``block`` for one padded shape (the capture,
        on the card)."""
        return Predictor(block, self.device, (bucket,) + key, self._dtype)

    def _build_ready_predictor(self, block, bucket, key):
        """Prewarm's build of one predictor: one timed program build (the
        capture on the card), an ``xla_compile`` span with the
        reference's prewarm attributes."""
        with _obs.compile_span("serving_predictor", shape=[bucket, *key],
                               dtype=self._dtype.str, aot=True):
            return self._build_predictor(block, bucket, key)

    # -- tenant hooks (overridden by serving/fleet.py) -----------------------
    def _admit_tenant(self, tenant, payload):
        """Tenant-registry admission gate: a single-tenant Server serves
        one anonymous family and refuses a tenant; the fleet looks the
        tenant up and applies its breaker and rate budget. Returns the
        tenant's state handle (None here)."""
        if tenant is not None:
            err = RequestError(
                f"unknown tenant {tenant!r}: this replica serves a "
                "single-tenant Server, not a fleet")
            err.tenant = tenant
            raise err
        return None

    def _note_reject(self, tenant):
        """Shape-reject hook (the fleet feeds its per-tenant breaker)."""

    def _effective_deadline(self, deadline_ms, tstate):
        """The tenant's SLO deadline floor (fleet); the identity here."""
        return self.config.default_deadline_ms if deadline_ms is None \
            else deadline_ms

    def _class_gate(self, tstate, tenant):
        """Per-tenant-class queue budget (fleet); only the hard bound
        sheds here."""

    def _note_shed(self, tenant):
        """Per-tenant shed hook (fleet)."""

    def _note_accept(self, tenant):
        """Per-tenant accept hook (fleet)."""

    def _note_cancelled(self, tenant):
        """Per-tenant cancel hook (the fleet frees a half-open probe)."""

    def _note_deadline_miss(self, tenant):
        """Per-tenant deadline-miss hook (fleet)."""

    # -- client surface ------------------------------------------------------
    def submit(self, x, deadline_ms=None, cancel=None,
               tenant=None, parent=None) -> PendingResponse:
        """Admit one sample (NO batch axis). Raises :class:`RequestError`
        for a shape outside the bucket grid or values the server's integer
        dtype would change, :class:`ServerOverloaded`
        when the bounded queue is full and :class:`ServerStopped` once
        ``stop()`` has closed admission. ``cancel`` (a
        ``threading.Event``) is checked at dequeue: the hedging router
        sets it on the losing attempt. ``tenant`` targets a fleet tenant
        (serving/fleet.py); a single-tenant Server refuses one with a
        structured error. ``parent`` (a trace ``SpanContext``) re-anchors
        the request's root span under a caller in another process: the
        worker passes the wire frame's context here."""
        if tenant is not None:
            # normalized once at the door: every later lookup (registry,
            # dequeue sweep, counters, journal) is by this string
            tenant = str(tenant)
        payload = self._payload(x, tenant)
        tstate = self._admit_tenant(tenant, payload)
        key = self.grid.feature_key(payload.shape)
        if key is None:
            with self._lock:
                self.counters["rejected_shape"] += 1
            self._note_reject(tenant)
            err = RequestError(
                f"request shape {tuple(payload.shape)} exceeds the bucket "
                f"grid {self.grid!r} — oversized inputs are rejected"
                + (f" [tenant: {tenant}]" if tenant else ""))
            err.retryable = False      # every replica shares the grid
            err.tenant = tenant
            raise err
        deadline_ms = self._effective_deadline(deadline_ms, tstate)
        deadline_s = None if deadline_ms is None or deadline_ms <= 0 \
            else deadline_ms / 1000.0
        self._class_gate(tstate, tenant)
        req = Request(payload, payload.shape, key, deadline_s=deadline_s,
                      cancel=cancel, tenant=tenant)
        # one span tree per request, its root closed by whichever thread
        # resolves the request; attributes are built only when tracing
        # is on, so admission costs nothing more with it off
        traced = _trace.enabled()
        if traced:
            req.trace = _trace.start_span("serving_request",
                                          parent=parent,
                                          shape=list(payload.shape))
        try:
            with self._admit_lock:
                stopped = self._closed
                if not stopped:
                    self._queue.put_nowait(req)
        except queue.Full:
            with self._lock:
                self.counters["shed"] += 1
            get_journal().event("serving_shed", depth=self._queue.qsize(),
                                limit=self.config.max_queue, tenant=tenant,
                                **_req_ids(req))
            self._note_shed(tenant)
            _end_span(req, "shed")
            raise ServerOverloaded(self._queue.qsize(),
                                   self.config.max_queue,
                                   tenant=tenant) from None
        if stopped:
            with self._lock:
                self.counters["rejected_stopped"] += 1
            get_journal().event("serving_stopped_reject",
                                stage="admission", **_req_ids(req))
            _end_span(req, "stopped")
            raise ServerStopped("server is stopping")
        if traced:
            _trace.event("enqueue", parent=req.trace,
                         depth=self._queue.qsize())
        with self._lock:
            self.counters["accepted"] += 1
        self._note_accept(tenant)
        return PendingResponse(req, self.config.result_timeout_s)

    def _payload(self, x, tenant=None):
        """``x`` as an array of the server's dtype. For an integer dtype
        (token ids) a value that the dtype would change — a fraction, or
        one outside its range — is a rejected request, not a silently
        different one."""
        if self._dtype.kind not in "iu":
            return np.asarray(x, dtype=self._dtype)
        given = np.asarray(x)
        if given.dtype.kind in "biuf":
            with np.errstate(invalid="ignore"):      # NaN: refused below
                payload = given.astype(self._dtype)
            if np.array_equal(payload, given):
                return payload
        err = RequestError(f"request of {given.dtype} values is not exactly "
                           f"{self._dtype} (the server's dtype)")
        err.retryable = False          # every replica shares the dtype
        err.tenant = tenant
        raise err

    def predict(self, x, deadline_ms=None, timeout_s=None, tenant=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(x, deadline_ms=deadline_ms,
                           tenant=tenant).result(timeout_s)

    def decode_submit(self, tokens, max_new_tokens=None, deadline_ms=None,
                      tenant=None):
        """Admit one autoregressive stream to the continuous batcher
        (``config.decode_model``); returns a
        :class:`~.decode.DecodeStream`. Without a decode model it raises
        the reference's non-retryable :class:`RequestError`."""
        if self.decoder is None:
            err = RequestError(
                "this server has no decode engine (config.decode_model "
                "is unset) — decode streams are not servable here")
            err.retryable = False
            err.tenant = tenant
            raise err
        return self.decoder.submit(tokens, max_new_tokens=max_new_tokens,
                                   deadline_ms=deadline_ms, tenant=tenant)

    def decode(self, tokens, max_new_tokens=None, deadline_ms=None,
               timeout_s=None, tenant=None):
        """Synchronous decode convenience: submit + wait → token list."""
        return self.decode_submit(
            tokens, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            tenant=tenant).result(timeout_s)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def beacon(self) -> dict:
        """Cheap readiness facts for the replica pool's heartbeat payload
        (no percentile math, no cache lock)."""
        t = self._last_batch_t
        alive = self._worker is not None and self._worker.is_alive()
        return {"queue_depth": self.queue_depth(),
                "params_step": self._params_step,
                "last_batch_age_s": None if t is None
                else round(time.monotonic() - t, 3),
                "ready": alive and not self._closed}

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        t = self._last_batch_t
        out = {"device": str(self.device),
               "queue_depth": self.queue_depth(),
               "params_step": self._params_step,
               "last_batch_age_s": None if t is None
               else time.monotonic() - t,
               "cache": self.cache.stats(),
               "prewarm": self.last_prewarm,
               "latency_ms": self.latency.summary(),
               "exec_ms": self.exec_ms.summary(),
               **counters}
        if self.decoder is not None:
            out["decode"] = self.decoder.stats()
        return out

    # -- metrics exposition --------------------------------------------------
    def metrics_text(self) -> str:
        """Prometheus text: the serving counters and gauges mirrored into
        the process default registry at call time, plus everything
        already there (program builds, step phases). The mirrors are
        gauges, so a second Server in one process cannot trip a
        counter's monotonicity check on the shared families."""
        from ..observability import metrics as _m
        reg = _m.default_registry()
        st = self.stats()
        sid = self._metrics_id
        reg.gauge("mxnet_tpu_serving_queue_depth",
                  "admission queue depth", ("server",)).labels(
            server=sid).set(st["queue_depth"])
        if st["params_step"] is not None:
            reg.gauge("mxnet_tpu_serving_params_step",
                      "hot-reloaded checkpoint step currently served",
                      ("server",)).labels(server=sid).set(
                st["params_step"])
        ev = reg.gauge("mxnet_tpu_serving_events",
                       "serving lifecycle counters (cumulative)",
                       ("server", "event"))
        for k in ("accepted", "served", "shed", "rejected_shape",
                  "rejected_stopped", "cancelled",
                  "deadline_miss_dequeue", "deadline_miss_post_batch",
                  "errors", "reloads", "batches"):
            ev.labels(server=sid, event=k).set(st[k])
        cache = st["cache"]
        ce = reg.gauge("mxnet_tpu_serving_cache_events",
                       "compiled-predictor cache counters (cumulative; "
                       "misses == compiles)", ("server", "event"))
        for k in ("hits", "misses", "evictions", "entries"):
            ce.labels(server=sid, event=k).set(cache[k])
        lat = st["latency_ms"]
        if lat["count"]:
            lq = reg.gauge("mxnet_tpu_serving_latency_ms",
                           "end-to-end request latency percentiles",
                           ("server", "quantile"))
            for q in ("p50", "p95", "p99"):
                lq.labels(server=sid, quantile=q).set(lat[q])
        return reg.prometheus_text()

    def start_metrics_server(self, host="127.0.0.1", port=0):
        """Expose ``GET /metrics`` (Prometheus text) on a stdlib daemon
        HTTP server; returns it (``.server_address[1]`` is the bound
        port; ``port=0`` picks a free one). Stopped by ``stop()``."""
        if self._metrics_httpd is None:
            from ..observability.export import serve_metrics
            self._metrics_httpd = serve_metrics(self.metrics_text,
                                                host=host, port=port)
        return self._metrics_httpd

    # -- worker --------------------------------------------------------------
    def _run(self):
        pending, draining = [], False
        try:
            while not self._stopping.is_set():
                if not pending:
                    try:
                        item = self._queue.get(
                            timeout=self.config.idle_poll_s)
                    except queue.Empty:
                        self._maybe_reload()
                        continue
                    if item is _STOP:
                        draining = True
                        break
                    pending.append(item)
                # coalescing window: absorb same-cycle arrivals
                t_end = time.monotonic() + self.config.window_ms / 1000.0
                while len(pending) < self.grid.max_batch:
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        item = self._queue.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if item is _STOP:
                        draining = True
                        break
                    pending.append(item)
                self._flush(pending)
                self._maybe_reload()
                if draining:
                    break
        finally:
            if draining and not self._stopping.is_set():
                self._drain_queue(pending)   # bounded: admission closed
                while pending:
                    self._flush(pending)
            self._drain_queue(pending)
            self._fail_remaining(pending)

    def _flush(self, pending):
        """Expire, group and run one micro-batch off ``pending``."""
        drop_expired(pending, self._on_dequeue_expired)
        self._drop_cancelled(pending)
        self._sweep_unroutable(pending)
        batch, bucket, key = take_batch(pending, self.grid,
                                        self._group_key)
        if batch:
            self._process(batch, bucket, key)

    # worker-loop grouping and sweep hooks (the fleet batches per
    # (tenant, key) and resolves a quarantined or removed tenant's queued
    # requests instead of spending batch slots on them)
    _group_key = None

    def _sweep_unroutable(self, pending):
        pass

    def _drop_cancelled(self, pending):
        """The dequeue half of hedging: a request whose cancel event is
        set (its twin already answered) is resolved with
        :class:`RequestCancelled` instead of spending a batch slot."""
        keep = []
        for req in pending:
            if req.cancelled():
                with self._lock:
                    self.counters["cancelled"] += 1
                get_journal().event("serving_cancelled", **_req_ids(req))
                self._note_cancelled(req.tenant)
                _end_span(req, "cancelled")
                req.set_error(RequestCancelled(
                    "cancelled at dequeue (hedged twin already answered)"))
            else:
                keep.append(req)
        pending[:] = keep

    def _on_dequeue_expired(self, req):
        late = req.late_ms()
        with self._lock:
            self.counters["deadline_miss_dequeue"] += 1
        get_journal().event("serving_deadline_miss", stage="dequeue",
                            late_ms=round(late, 2), tenant=req.tenant,
                            **_req_ids(req))
        self._note_deadline_miss(req.tenant)
        _end_span(req, "deadline_miss_dequeue")
        req.set_error(DeadlineExceeded("dequeue", late, tenant=req.tenant))

    def _drain_queue(self, pending):
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                pending.append(item)

    def _fail_remaining(self, pending):
        for req in pending:
            with self._lock:
                self.counters["rejected_stopped"] += 1
            _end_span(req, "stopped")
            req.set_error(ServerStopped("server stopped before this "
                                        "request was served"))
        pending.clear()

    def _process(self, batch, bucket, key):
        n = len(batch)
        # the batch is a trace of its own, linked both ways: it lists
        # its requests' spans, and each request's ``execute`` child
        # names the batch span
        with _trace.span(
                "serving_batch", batch=n, bucket=bucket, key=list(key),
                request_spans=[i["span_id"] for r in batch
                               for i in [_req_ids(r)] if i]) as bsp:
            self._process_traced(batch, bucket, key, n, bsp)

    # -- execution hooks (overridden by serving/fleet.py) --------------------
    def _acquire_predictor(self, batch, bucket, key):
        """``(cache key, builder)`` of this batch's predictor. The cache
        lookup and a miss's build (the capture, on the card) run under
        the batch's program-build span; the fleet pages a cold tenant in
        here, before that span and outside ``exec_ms``."""
        return ((bucket, key, self._dtype.str),
                lambda: self._build_predictor(self.block, bucket, key))

    def _trip_sites(self, batch):
        """Chaos seam consulted per predictor call (``serving_predict``);
        the fleet adds the per-tenant ``serving_tenant`` site."""
        _atomic.trip("serving_predict", self._metrics_id)

    def _note_predict_error(self, batch, exc):
        """Failed-batch hook: the fleet feeds the tenant's breaker."""

    def _batch_step(self, batch):
        """Checkpoint step stamped on this batch's answers (the fleet
        answers per tenant)."""
        return self._params_step

    def _batch_fields(self, batch) -> dict:
        """Extra fields of the ``serving_batch`` record (the fleet adds
        ``tenant``)."""
        return {}

    def _observe_latency(self, req, ms):
        self.latency.observe(ms)

    def _batch_succeeded(self, batch):
        """Delivered-batch hook: the fleet's half-open probe re-admits
        its tenant here."""

    def _process_traced(self, batch, bucket, key, n, bsp):
        cfg = self.config
        padded = np.full((bucket,) + key, cfg.pad_value, dtype=self._dtype)
        for i, req in enumerate(batch):
            padded[(i,) + tuple(slice(0, d) for d in req.shape)] = req.payload
        tenant = batch[0].tenant
        try:
            cache_key, build = self._acquire_predictor(batch, bucket, key)
        except Exception as exc:
            self._fail_batch(batch, n, bucket, tenant, exc,
                             where="serving_page_in")
            return
        try:
            # a cache miss builds the predictor (the capture, on the
            # card) and runs it: the timed program build of this site
            with _obs.maybe_compile_span(
                    not self.cache.contains(cache_key),
                    "serving_predictor", bucket=bucket, key=list(key),
                    dtype=self._dtype.str, includes_execute=True):
                predictor, hit = self.cache.get(cache_key, build)
                t0 = time.perf_counter()
                self._trip_sites(batch)
                outs, treedef = predictor(padded)
                t1 = time.perf_counter()
            exec_ms = (t1 - t0) * 1000.0
            self.exec_ms.observe(exec_ms)
        except Exception as exc:         # a failed batch fails its requests
            self._fail_batch(batch, n, bucket, tenant, exc,
                             where="serving_predict")
            return
        now = time.monotonic()
        delivered = 0
        step = self._batch_step(batch)
        for i, req in enumerate(batch):
            if req.expired(now):
                late = req.late_ms(now)
                with self._lock:
                    self.counters["deadline_miss_post_batch"] += 1
                get_journal().event("serving_deadline_miss",
                                    stage="post_batch",
                                    late_ms=round(late, 2),
                                    tenant=req.tenant, **_req_ids(req))
                self._note_deadline_miss(req.tenant)
                _end_span(req, "deadline_miss_post_batch")
                req.set_error(DeadlineExceeded("post_batch", late,
                                               tenant=req.tenant), now)
                continue
            rows = []
            for o in outs:
                row = o[i] if o.ndim >= 1 and o.shape[0] == bucket else o
                if cfg.crop_outputs and row.shape == key \
                        and req.shape != key:
                    row = row[tuple(slice(0, d) for d in req.shape)]
                rows.append(row)
            if req.trace is not None and req.trace.span_id is not None:
                # the batch's execution window, under this request's root
                _trace.record("execute", parent=req.trace, t0=t0, t1=t1,
                              batch_span=bsp.span_id, batch=n,
                              bucket=bucket)
                _trace.event("respond", parent=req.trace)
            _end_span(req, "ok")
            req.params_step = step                 # version stamp
            req.set_result(rows[0] if treedef is None else treedef(rows),
                           now)
            delivered += 1
            self._observe_latency(req, (now - req.enq_t) * 1000.0)
        self._last_batch_t = time.monotonic()
        with self._lock:
            self.counters["served"] += delivered
            self.counters["batches"] += 1
        if delivered:
            self._batch_succeeded(batch)
        lat = self.latency.summary()
        cache_st = self.cache.stats()      # one snapshot: consistent trio
        get_journal().event(
            "serving_batch", queue_depth=self._queue.qsize(), batch=n,
            delivered=delivered, bucket=bucket, fill=round(n / bucket, 4),
            pad_waste=BucketGrid.pad_waste(
                n, bucket, [r.shape for r in batch], key),
            cache_hit=hit, exec_ms=round(exec_ms, 2),
            params_step=step,
            hits=cache_st["hits"], misses=cache_st["misses"],
            evictions=cache_st["evictions"],
            p50_ms=lat["p50"], p95_ms=lat["p95"], p99_ms=lat["p99"],
            **self._batch_fields(batch))

    def _fail_batch(self, batch, n, bucket, tenant, exc, where):
        """Resolve every request of a failed batch with one structured,
        tenant-labelled error, journal the crash and feed the tenant's
        fault domain."""
        with self._lock:
            self.counters["errors"] += n
        get_journal().crash(exc, where=where, batch=n, bucket=bucket,
                            tenant=tenant)
        self._note_predict_error(batch, exc)
        err = RequestError(f"predictor failed: {type(exc).__name__}: {exc}"
                           + (f" [tenant: {tenant}]" if tenant else ""))
        err.__cause__ = exc
        err.tenant = tenant
        for req in batch:
            _end_span(req, "error")
            req.set_error(err)

    # -- hot reload ----------------------------------------------------------
    def _check_reloadable(self, loaded, block=None):
        """Check every live parameter and buffer of ``block`` (default
        the server's) against the checkpoint up front (``arg:``/``aux:``
        prefixes normalized as ``load_dict`` does): each must be there,
        with the live shape. Raises on drift; returns the normalized
        dict."""
        norm = {(k.partition(":")[2] if k.partition(":")[0] in
                 ("arg", "aux") and ":" in k else k): v
                for k, v in loaded.items()}
        block = self.block if block is None else block
        for key, param in block.collect_params().items():
            if key not in norm:
                raise MXNetError(f"checkpoint missing parameter {key!r}")
            got = tuple(norm[key].shape)
            if not is_lazy(param) and tuple(param.shape) != got:
                raise MXNetError(
                    f"checkpoint parameter {key!r} is {got}, live "
                    f"parameter is {tuple(param.shape)} — architecture "
                    "drift; not hot-reloadable")
        return norm

    def pin_params(self, step):
        """Pin the hot-reload store to ``step`` (None unpins). The pin
        lands at once (``poll`` stops advancing past it); when the live
        step differs, the load and copy happen on the worker thread at
        its next turn, between batches, a downgrade (a rollback)
        included. Returns True when a store exists to pin."""
        store = self.param_store
        if store is None:
            return False
        store.pin_step(step)
        with self._lock:
            self._pin_dirty = step is not None
        return True

    def _apply_params(self, step, loaded, prev, load_s=0.0):
        """Apply a loaded parameter dict: the whole dict checked against
        the live shapes first, then copied into the live tensors in place
        (``load_dict``), so the captured graphs read the new weights.
        The copy runs on this thread's current stream and is waited for
        before the next batch."""
        store = self.param_store
        loaded = {k: v for k, v in loaded.items() if not k.startswith("__")}
        t0 = time.perf_counter()
        try:
            # a checkpoint that validated but does not fit (architecture
            # drift) must never half-apply
            self._check_reloadable(loaded)
            self.block.load_dict(loaded, ctx=self._ctx, ignore_extra=True)
            if self.device.type == "cuda":
                # this stream only: a device-wide synchronize fails while
                # another thread captures a graph (a replica starting)
                torch.cuda.current_stream(self.device).synchronize()
        except MXNetError as e:
            store.mark_bad(step, revert_to=prev)
            get_journal().event("serving_reload_failed", step=step,
                                error=type(e).__name__, detail=str(e)[:300])
            return False
        self._params_step = step
        with self._lock:
            self.counters["reloads"] += 1
        get_journal().event(
            "serving_reload", step=step, n_params=len(loaded),
            prev_step=prev, load_s=round(load_s, 6),
            apply_s=round(time.perf_counter() - t0, 6),
            bytes=sum(v.numel() * v.element_size() for v in loaded.values()))
        return True

    def _apply_pin(self, store):
        """Converge the live step onto the pinned one: an explicit load of
        one named step (downgrades allowed). A failure journals and
        stays on the current version."""
        pinned = store.pinned_step
        if pinned is None or self._params_step == pinned:
            return False
        return self._load(pinned, store.load_step, pinned)

    def _maybe_reload(self, force=False):
        """The reload's turn on the worker thread, between batches: a
        finished load is applied; else a pin or a due poll starts one on
        the loader thread (at ``start()``, before there is one, it loads
        and applies here)."""
        store = self.param_store
        if store is None:
            return False
        if self._reload_job is not None:
            target, job = self._reload_job
            if not job.done():
                return False
            self._reload_job = None
            return self._apply_load(target, *job.result())
        with self._lock:
            pin_dirty, self._pin_dirty = self._pin_dirty, False
        if pin_dirty:
            # the pin lane bypasses the poll throttle (and a disabled
            # poller): a rollback starts at the next turn
            return self._apply_pin(store)
        poll_s = self.config.reload_poll_s
        if poll_s < 0 and not force:
            return False
        now = time.monotonic()
        if not force and self._last_reload_check is not None and \
                now - self._last_reload_check < poll_s:
            return False
        self._last_reload_check = now
        return self._load(None, store.poll)

    def _load(self, target, fn, *args):
        """Run ``fn`` (``store.poll`` or ``store.load_step``) on the loader
        thread, or here and apply its result when there is none."""
        if self._loader is None:
            return self._apply_load(target, *_timed_load(fn, *args))
        self._reload_job = (target, self._loader.submit(_timed_load, fn,
                                                        *args))
        return False

    def _apply_load(self, target, got, load_s):
        """Apply what a load returned: (step, dict), None (nothing new),
        or the error of the explicit load of step ``target``."""
        if isinstance(got, Exception):
            get_journal().event("serving_reload_failed", step=target,
                                error=type(got).__name__,
                                detail=str(got)[:300])
            return False
        if got is None:
            return False
        step, loaded = got
        return self._apply_params(step, loaded, self._params_step, load_s)


def _timed_load(fn, *args):
    """(what ``fn(*args)`` returned or the load error it raised,
    seconds)."""
    t0 = time.perf_counter()
    try:
        got = fn(*args)
    except (ValueError, MXNetError, OSError) as e:
        got = e
    return got, time.perf_counter() - t0
