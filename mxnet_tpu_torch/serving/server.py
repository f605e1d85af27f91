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
a CUDA device and without that request it raises at construction.

Not ported yet: hot reload, the AOT cache, shard plans, the decode
engine, tenants and fleets, the journal, tracing and metrics
exposition, tuned tables, device retries and environment-variable
defaults.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
from torch.nn.parameter import is_lazy

from ..base import MXNetError
from ..context import resolve_device
from .batcher import (DeadlineExceeded, PendingResponse, Request,
                      RequestError, ServerOverloaded, ServerStopped,
                      drop_expired, take_batch)
from .buckets import BucketGrid
from .cache import Predictor, PredictorCache

__all__ = ["LatencySummary", "Server", "ServerConfig"]

_STOP = object()


class LatencySummary:
    """count/mean/min/max over every observation and nearest-rank
    p50/p95/p99 over the most recent ``window`` ones. Thread-safe."""

    def __init__(self, window=4096):
        self._recent = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._recent.clear()
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def observe(self, value):
        v = float(value)
        with self._lock:
            self._recent.append(v)
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    def summary(self) -> dict:
        with self._lock:
            buf = sorted(self._recent)
            count, total, lo, hi = self._count, self._sum, self._min, \
                self._max
        if not count:
            return {"count": 0, "mean": None, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}

        def rank(p):
            r = max(int(math.ceil(p / 100.0 * len(buf))) - 1, 0)
            return buf[min(r, len(buf) - 1)]

        return {"count": count, "mean": total / count, "min": lo, "max": hi,
                "p50": rank(50), "p95": rank(95), "p99": rank(99)}


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
    idle_poll_s: float = 0.05                # worker wake granularity
    dtype: str = "float32"                   # request payload dtype
    pad_value: float = 0.0
    crop_outputs: bool = True                # unpad outputs that kept dims
    result_timeout_s: float = 60.0           # PendingResponse default wait


class Server:
    """Dynamic-batching inference server around one initialized Block.

    ``ctx`` picks the device (default ``cuda:0``); the block's
    parameters must already live there (``initialize(ctx=...)`` or a
    load onto it)."""

    def __init__(self, block, config=None, ctx=None):
        self.block = block
        self.config = cfg = config or ServerConfig()
        self.device = resolve_device(ctx)
        for name, t in block.state_dict(keep_vars=True).items():
            if not is_lazy(t) and t.device != self.device:
                raise MXNetError(f"parameter {name} is on {t.device}; the "
                                 f"server runs on {self.device}")
        self.grid = BucketGrid(cfg.max_batch, cfg.batch_buckets,
                               cfg.dim_buckets)
        self.cache = PredictorCache(cfg.cache_entries)
        self.latency = LatencySummary()
        self.exec_ms = LatencySummary()    # per batch: predictor call
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
        self._last_batch_t = None
        self.counters = {"accepted": 0, "served": 0, "shed": 0,
                         "rejected_shape": 0, "rejected_stopped": 0,
                         "deadline_miss_dequeue": 0,
                         "deadline_miss_post_batch": 0, "errors": 0,
                         "batches": 0}

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stopping.clear()
        with self._admit_lock:
            self._closed = False
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

    # -- client surface ------------------------------------------------------
    def submit(self, x, deadline_ms=None) -> PendingResponse:
        """Admit one sample (NO batch axis). Raises :class:`RequestError`
        for a shape outside the bucket grid, :class:`ServerOverloaded`
        when the bounded queue is full and :class:`ServerStopped` once
        ``stop()`` has closed admission."""
        payload = np.asarray(x, dtype=self._dtype)
        key = self.grid.feature_key(payload.shape)
        if key is None:
            with self._lock:
                self.counters["rejected_shape"] += 1
            err = RequestError(
                f"request shape {tuple(payload.shape)} exceeds the bucket "
                f"grid {self.grid!r} — oversized inputs are rejected")
            err.retryable = False      # every replica shares the grid
            raise err
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline_s = None if deadline_ms is None or deadline_ms <= 0 \
            else deadline_ms / 1000.0
        req = Request(payload, payload.shape, key, deadline_s=deadline_s)
        try:
            with self._admit_lock:
                stopped = self._closed
                if not stopped:
                    self._queue.put_nowait(req)
        except queue.Full:
            with self._lock:
                self.counters["shed"] += 1
            raise ServerOverloaded(self._queue.qsize(),
                                   self.config.max_queue) from None
        if stopped:
            with self._lock:
                self.counters["rejected_stopped"] += 1
            raise ServerStopped("server is stopping")
        with self._lock:
            self.counters["accepted"] += 1
        return PendingResponse(req, self.config.result_timeout_s)

    def predict(self, x, deadline_ms=None, timeout_s=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(x, deadline_ms=deadline_ms).result(timeout_s)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        t = self._last_batch_t
        return {"device": str(self.device),
                "queue_depth": self.queue_depth(),
                "last_batch_age_s": None if t is None
                else time.monotonic() - t,
                "cache": self.cache.stats(),
                "latency_ms": self.latency.summary(),
                "exec_ms": self.exec_ms.summary(),
                **counters}

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
        batch, bucket, key = take_batch(pending, self.grid)
        if batch:
            self._process(batch, bucket, key)

    def _on_dequeue_expired(self, req):
        late = req.late_ms()
        with self._lock:
            self.counters["deadline_miss_dequeue"] += 1
        req.set_error(DeadlineExceeded("dequeue", late))

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
            req.set_error(ServerStopped("server stopped before this "
                                        "request was served"))
        pending.clear()

    def _process(self, batch, bucket, key):
        cfg = self.config
        n = len(batch)
        padded = np.full((bucket,) + key, cfg.pad_value, dtype=self._dtype)
        for i, req in enumerate(batch):
            padded[(i,) + tuple(slice(0, d) for d in req.shape)] = req.payload
        try:
            predictor, _ = self.cache.get(
                (bucket, key, self._dtype.str),
                lambda: Predictor(self.block, self.device,
                                  (bucket,) + key))
            t0 = time.perf_counter()
            outs, treedef = predictor(padded)
            self.exec_ms.observe((time.perf_counter() - t0) * 1000.0)
        except Exception as exc:         # a failed batch fails its requests
            with self._lock:
                self.counters["errors"] += n
            err = RequestError(f"predictor failed: "
                               f"{type(exc).__name__}: {exc}")
            err.__cause__ = exc
            for req in batch:
                req.set_error(err)
            return
        now = time.monotonic()
        delivered = 0
        for i, req in enumerate(batch):
            if req.expired(now):
                with self._lock:
                    self.counters["deadline_miss_post_batch"] += 1
                req.set_error(DeadlineExceeded("post_batch",
                                               req.late_ms(now)), now)
                continue
            rows = []
            for o in outs:
                row = o[i] if o.ndim >= 1 and o.shape[0] == bucket else o
                if cfg.crop_outputs and row.shape == key \
                        and req.shape != key:
                    row = row[tuple(slice(0, d) for d in req.shape)]
                rows.append(row)
            req.set_result(rows[0] if treedef is None else treedef(rows),
                           now)
            delivered += 1
            self.latency.observe((now - req.enq_t) * 1000.0)
        self._last_batch_t = time.monotonic()
        with self._lock:
            self.counters["served"] += delivered
            self.counters["batches"] += 1
