"""Continuous-batching autoregressive decode engine (counterpart of
``mxnet_tpu/serving/decode.py``).

The one-shot batcher (``serving/server.py``) coalesces independent
requests; autoregressive generation is hundreds of small dependent steps
per sequence. This engine is the serving tier's second executor, run
beside the one-shot worker:

- a fixed **slot pool** (``MXNET_TPU_DECODE_SLOTS``) of resident
  per-sequence state (the KV-cache analog) admits streams, so device
  memory is bounded by configuration;
- **prefill/decode split**: an admitted prompt is absorbed in padded
  chunks on a power-of-two prefill lattice up to
  ``MXNET_TPU_DECODE_PREFILL_CHUNK``, then the stream joins the resident
  step batch;
- **per-step rebatching**: every step runs one program over the whole
  ``(slots, 1)`` token tensor with an active mask; a finished stream
  frees its slot for the next queued prompt between steps. The step
  shape is the dedicated decode lattice's single cell
  (:meth:`~.buckets.BucketGrid.for_decode`);
- **exact program accounting**: programs live in an explicit cache and
  ``stats()["compiles"]`` counts every build: one step program and one
  prefill program per chunk bucket after :meth:`DecodeEngine.warmup`.
  On ``cuda:0`` a program is one CUDA graph over static device buffers
  (the resident state, read and written in place, and the program's
  inputs, which each call copies in before the replay), captured once;
  on the CPU, which a caller asks for explicitly, it is the eager
  function over the same buffers. A build after ``warmup()`` is the
  defect the reference's zero-mid-run-compile check names;
- **deadlines and cancellation**: per-stream deadlines are checked at
  admission and every step (a mid-decode expiry preempts the stream);
  ``DecodeStream.cancel()`` frees the slot at the next step boundary.
  Failures are the structured batcher errors the router classifies:
  ``SlotsExhausted`` is retryable, a deadline miss is not;
- the journal gets ``decode_start``, ``decode_warmup``, ``decode_admit``,
  ``decode_step``, ``decode_finish``, ``decode_cancel``,
  ``decode_preempt``, ``decode_deadline_miss``, ``decode_shed`` and
  ``decode_stop`` with the reference's fields.

Each program build (a CUDA-graph capture on the card) runs inside an
``xla_compile`` span, site ``decode_program``, as the reference's XLA
compile does; ``stats()`` counts the builds too.

Not ported yet: a shard plan's placement of the state (``plan=``) waits
for ``shardplan.py`` (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..context import resolve_device
from ..diagnostics.journal import get_journal
from ..gluon import cached_graph as _cg
from ..metric import LatencySummary
from ..observability import instrument as _obs
from .batcher import (DeadlineExceeded, RequestError, ServerOverloaded,
                      ServerStopped, SlotsExhausted)
from .buckets import BucketGrid

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeModel", "DecodeStream",
           "TinyLM"]

_STOP = object()
_engine_seq = itertools.count()


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _pow2_up_to(n):
    out, b = [], 1
    while b < n:
        out.append(b)
        b *= 2
    out.append(int(n))
    return tuple(out)


class DecodeModel:
    """The contract the engine drives: three functions over a
    slot-resident state dict of tensors (leading dim the slot count) on
    the engine's device. Every argument is a tensor on that device: on
    the card the functions are captured into CUDA graphs, so they must
    not read a value back to the host or branch on one. ``max_len``
    bounds per-slot positions; admission enforces ``prompt +
    max_new_tokens <= max_len``.

    ``init_state(slots)``
        The resident pool ``{name: tensor[(slots, ...)]}`` (any device;
        the engine moves it onto its own once).
    ``prefill_fn(state, slot, tokens, length, start)``
        Absorb one padded prompt chunk (``tokens[(chunk,)]``, valid
        prefix ``length``; ``slot``, ``length``, ``start`` 0-d int32)
        into ``slot`` at offset ``start``; ``start == 0`` resets the
        slot. Returns the new state.
    ``step_fn(state, tokens, active)``
        One step over the whole pool: absorb ``tokens[(slots, 1)]``
        where ``active`` (bool ``(slots,)``) and return ``(state,
        next_tokens[(slots,)])``.
    """

    max_len = 256

    def init_state(self, slots):
        raise NotImplementedError

    def prefill_fn(self, state, slot, tokens, length, start):
        raise NotImplementedError

    def step_fn(self, state, tokens, active):
        raise NotImplementedError


class TinyLM(DecodeModel):
    """Deterministic toy LM: an integer hash chain. The next token is a
    function of (running hash, position), both updated in exact int32
    arithmetic (``%`` is a floor modulo on int32 tensors, as in the
    reference), so the engine's output is bit-checkable against
    :meth:`reference`. The ``kv`` buffer records the absorbed tokens per
    slot. Writes past a slot's row (padded chunk tails, inactive slots,
    a slot at ``pos == max_len``) are dropped by a mask, never by an
    out-of-range index (which on the card is a device-side assert)."""

    def __init__(self, vocab=251, max_len=256):
        self.vocab = int(vocab)
        self.max_len = int(max_len)

    def init_state(self, slots):
        return {"pos": torch.zeros((slots,), dtype=torch.int32),
                "acc": torch.zeros((slots,), dtype=torch.int32),
                "kv": torch.zeros((slots, self.max_len), dtype=torch.int32)}

    def prefill_fn(self, state, slot, tokens, length, start):
        V = self.vocab
        kv = state["kv"]
        pick = slot.reshape(1)
        fresh = start == 0
        acc = torch.where(fresh, torch.zeros_like(start),
                          state["acc"].index_select(0, pick)[0])
        row = torch.where(fresh, torch.zeros_like(kv[0]),
                          kv.index_select(0, pick)[0])
        # token i of the chunk lands at column start + i for i < length
        cols = torch.arange(kv.shape[1], dtype=torch.int32,
                            device=kv.device)
        rel = cols - start
        inside = (rel >= 0) & (rel < length)
        src = tokens.index_select(
            0, rel.clamp(0, tokens.shape[0] - 1).long())
        row = torch.where(inside, src, row)
        for i in range(tokens.shape[0]):        # the reference's fori_loop
            acc = torch.where(i < length, (acc * 31 + tokens[i] + 1) % V,
                              acc)
        sel = torch.arange(kv.shape[0], device=kv.device) == slot
        return {"pos": torch.where(sel, start + length, state["pos"]),
                "acc": torch.where(sel, acc, state["acc"]),
                "kv": torch.where(sel[:, None], row[None, :], kv)}

    def step_fn(self, state, tokens, active):
        V = self.vocab
        tok = tokens[:, 0]
        acc = torch.where(active, (state["acc"] * 31 + tok + 1) % V,
                          state["acc"])
        pos = state["pos"]
        cols = torch.arange(state["kv"].shape[1], dtype=torch.int32,
                            device=pos.device)
        write = active[:, None] & (cols[None, :] == pos[:, None])
        kv = torch.where(write, tok[:, None], state["kv"])
        pos = torch.where(active, pos + 1, pos)
        nxt = (acc * 33 + pos * 7 + 5) % V
        return {"pos": pos, "acc": acc, "kv": kv}, nxt

    def reference(self, prompt, n):
        """Pure-Python replay of prefill(prompt[:-1]) + n steps: the
        exact oracle for the engine."""
        V = self.vocab
        acc = pos = 0
        for t in prompt[:-1]:
            acc = (acc * 31 + int(t) + 1) % V
            pos += 1
        out, tok = [], int(prompt[-1])
        for _ in range(n):
            acc = (acc * 31 + tok + 1) % V
            pos += 1
            tok = (acc * 33 + pos * 7 + 5) % V
            out.append(tok)
        return out


@dataclass
class DecodeConfig:
    """Decode-engine knobs (``MXNET_TPU_DECODE_*`` set defaults)."""

    slots: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_DECODE_SLOTS", 8))
    prefill_chunk: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_DECODE_PREFILL_CHUNK", 32))
    # idle admission window: how long the worker waits for a first stream
    # when no slot is occupied (with streams active admission does not
    # wait: waiting would tax every token)
    window_ms: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DECODE_WINDOW_MS", 20.0))
    max_queue: int = 64                      # bounded slot-wait queue
    max_new_tokens: int = 64                 # per-stream default cap
    default_deadline_ms: float = 10000.0
    queue_on_busy: bool = True               # False: SlotsExhausted now
    result_timeout_s: float = 60.0

    def summary(self) -> dict:
        return {"slots": self.slots, "prefill_chunk": self.prefill_chunk,
                "window_ms": self.window_ms, "max_queue": self.max_queue,
                "max_new_tokens": self.max_new_tokens,
                "default_deadline_ms": self.default_deadline_ms,
                "queue_on_busy": self.queue_on_busy}


class DecodeStream:
    """Caller-side handle of one admitted stream: ``result(timeout_s)``
    blocks (bounded) until it finishes and returns the generated tokens
    or raises its structured error; ``tokens`` snapshots progress;
    ``cancel()`` frees the slot at the next step boundary (or drops the
    stream from the queue before admission)."""

    __slots__ = ("prompt", "max_new", "deadline_ts", "enq_t", "tenant",
                 "done", "error", "slot", "pending_tok", "_generated",
                 "_timeout_s", "admit_t", "finish_t", "cancel_evt")

    def __init__(self, prompt, max_new, deadline_s, tenant, timeout_s):
        now = time.monotonic()
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_ts = None if deadline_s is None else now + deadline_s
        self.enq_t = now
        self.tenant = tenant
        self.done = threading.Event()
        self.error = None
        self.slot = None
        self.pending_tok = int(prompt[-1])   # the next step's input token
        self._generated = []
        self._timeout_s = timeout_s
        self.admit_t = None
        self.finish_t = None
        self.cancel_evt = threading.Event()

    def cancel(self):
        self.cancel_evt.set()

    def cancelled(self) -> bool:
        return self.cancel_evt.is_set()

    @property
    def tokens(self):
        return list(self._generated)

    def result(self, timeout_s=None):
        timeout_s = self._timeout_s if timeout_s is None else timeout_s
        if not self.done.wait(timeout=timeout_s):
            raise RequestError(
                f"decode stream unresolved within {timeout_s:g}s (engine "
                "stopped or wedged — check the serving journal)")
        if self.error is not None:
            raise self.error
        return list(self._generated)

    def expired(self, now=None) -> bool:
        return self.deadline_ts is not None and \
            (time.monotonic() if now is None else now) > self.deadline_ts

    def late_ms(self, now=None) -> float:
        if self.deadline_ts is None:
            return 0.0
        now = time.monotonic() if now is None else now
        return max(now - self.deadline_ts, 0.0) * 1000.0

    def _finish(self, now=None):
        self.finish_t = time.monotonic() if now is None else now
        self.done.set()

    def _fail(self, exc, now=None):
        self.error = exc
        self._finish(now)


class _Program:
    """One decode program: ``fn`` over the engine's resident state and
    this program's input buffers. On the card the constructor warms
    ``fn`` up on a side stream (the state kept as it was) and captures it
    into a CUDA graph; a call writes its inputs into the buffers and
    replays. On the CPU a call runs ``fn``."""

    def __init__(self, fn, buffers, state, device):
        self.fn = fn
        self.buffers = buffers
        self.graph = None
        self.out = None
        if device.type == "cuda":
            with _cg._capture_lock, torch.inference_mode(False), \
                    torch.no_grad():
                saved = {k: v.clone() for k, v in state.items()}
                _cg.CudaGraphs.warm_up(fn, device)
                for k, v in saved.items():
                    state[k].copy_(v)
                self.graph, self.out = _cg.CudaGraphs.capture(
                    fn, _cg.CudaGraphs.new_pool(device), (), device)

    def __call__(self, **inputs):
        with torch.no_grad():
            for name, value in inputs.items():
                buf = self.buffers[name]
                if buf.dim() == 0:
                    buf.fill_(int(value))
                else:
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            if self.graph is None:
                return self.fn()
            self.graph.replay()
            return self.out


class DecodeEngine:
    """The continuous batcher: one worker thread owns the slot pool and
    runs the programs; callers enqueue prompts into a bounded queue (or
    bounce with :class:`SlotsExhausted` when ``queue_on_busy=False``).
    ``ctx`` picks the device (default ``cuda:0``; raises without a card
    unless it is the CPU)."""

    def __init__(self, model, config=None, ctx=None, plan=None):
        if plan is not None:
            raise NotImplementedError(
                "a shard plan for the decode state waits for shardplan.py "
                "(ROADMAP Queue 1 item 9)")
        self.model = model
        self.config = config or DecodeConfig()
        cfg = self.config
        if cfg.slots < 1:
            raise ValueError(f"DecodeEngine needs slots >= 1, got "
                             f"{cfg.slots}")
        self.device = resolve_device(ctx)
        # the two lattices: a single-cell decode grid for the (slots, 1)
        # step tensor, a pow2 chunk grid for prefill
        self.grid = BucketGrid.for_decode(cfg.slots)
        assert (self.grid.batch_bucket(cfg.slots),) + \
            self.grid.feature_key((1,)) == (cfg.slots, 1)
        self.prefill_buckets = _pow2_up_to(cfg.prefill_chunk)
        self._id = f"dec{next(_engine_seq)}"
        self._queue = queue.Queue(maxsize=cfg.max_queue)
        self._slots = [None] * cfg.slots     # slot -> DecodeStream
        self._state = None                   # resident model state
        self._programs = {}                  # ("step",) | ("prefill", b)
        # program builds (their warm-up touches the state) and runs
        self._run_lock = threading.RLock()
        self._worker = None
        self._stopping = threading.Event()
        self._closed = False
        self._admit_lock = threading.Lock()
        self._lock = threading.Lock()
        self.step_latency = LatencySummary("decode_step_ms")
        self.counters = {"submitted": 0, "admitted": 0, "completed": 0,
                         "cancelled": 0, "preempted": 0, "shed": 0,
                         "rejected": 0, "steps": 0, "compiles": 0,
                         "tokens_out": 0}

    # -- programs (an explicit cache: every build is counted) ------------
    def _ensure_state(self):
        if self._state is None:
            st = self.model.init_state(self.config.slots)
            self._state = {k: torch.as_tensor(v).to(self.device).clone()
                           for k, v in st.items()}
        return self._state

    def _program(self, key):
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        with self._run_lock:
            prog = self._programs.get(key)
            if prog is not None:
                return prog
            state = self._ensure_state()
            model, dev = self.model, self.device

            def buf(*shape, dtype=torch.int32):
                return torch.zeros(shape, dtype=dtype, device=dev)

            if key[0] == "step":
                b = {"tokens": buf(self.config.slots, 1),
                     "active": buf(self.config.slots, dtype=torch.bool)}

                def fn():
                    new, nxt = model.step_fn(state, b["tokens"], b["active"])
                    _assign(state, new)
                    return nxt
            else:
                b = {"slot": buf(), "tokens": buf(key[1]),
                     "length": buf(), "start": buf()}

                def fn():
                    _assign(state, model.prefill_fn(
                        state, b["slot"], b["tokens"], b["length"],
                        b["start"]))
            with _obs.compile_span("decode_program", program=list(key),
                                   engine=self._id):
                prog = _Program(fn, b, state, dev)
            with self._lock:
                self.counters["compiles"] += 1
            self._programs[key] = prog
        return prog

    def warmup(self) -> dict:
        """Build the whole program set (one step program and one prefill
        program per chunk bucket) ahead of traffic. Returns {programs,
        compiled, ms} and journals ``decode_warmup``."""
        t0 = time.perf_counter()
        before = self.counters["compiles"]
        self._program(("step",))
        for b in self.prefill_buckets:
            self._program(("prefill", b))
        out = {"programs": len(self._programs),
               "compiled": self.counters["compiles"] - before,
               "ms": round((time.perf_counter() - t0) * 1000.0, 2)}
        get_journal().event("decode_warmup", engine=self._id, **out)
        return out

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stopping.clear()
        with self._admit_lock:
            self._closed = False
        self._ensure_state()
        get_journal().event("decode_start", engine=self._id,
                            config=self.config.summary(),
                            grid=repr(self.grid),
                            prefill_buckets=list(self.prefill_buckets))
        self._worker = threading.Thread(
            target=self._run, name="mxnet-torch-decode-worker", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout_s=30.0, drain=True):
        """With ``drain`` every admitted stream (active or queued) runs to
        completion before the worker exits; without, all resolve with
        :class:`ServerStopped`. Admission closes first; bounded join."""
        if self._worker is None:
            return
        with self._admit_lock:
            self._closed = True
        if not drain:
            self._stopping.set()
        try:
            self._queue.put(_STOP, timeout=timeout_s)
        except queue.Full:
            self._stopping.set()
        self._worker.join(timeout=timeout_s)
        stuck = self._worker.is_alive()
        if not stuck:
            leftovers = []
            with self._admit_lock:
                self._drain_queue(leftovers)
            self._fail_streams(leftovers)
        get_journal().event("decode_stop", engine=self._id,
                            drained=bool(drain), stuck=stuck,
                            **self.stats())
        if stuck:
            raise RequestError(
                f"decode worker did not stop within {timeout_s:g}s "
                "(device wedged mid-step? see the journal)")
        self._worker = None

    # -- client surface --------------------------------------------------
    def submit(self, tokens, max_new_tokens=None, deadline_ms=None,
               tenant=None) -> DecodeStream:
        """Admit one prompt (1-D int token sequence). Raises
        :class:`RequestError` for an empty or oversized prompt (not
        retryable), :class:`SlotsExhausted` when ``queue_on_busy=False``
        and no slot is free (retryable), :class:`ServerOverloaded` when
        the slot-wait queue is full and :class:`ServerStopped` after
        ``stop()``."""
        cfg = self.config
        prompt = [int(t) for t in np.asarray(tokens).reshape(-1)]
        max_new = cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        with self._lock:
            self.counters["submitted"] += 1
        if not prompt or max_new < 1 or \
                len(prompt) + max_new > self.model.max_len:
            with self._lock:
                self.counters["rejected"] += 1
            err = RequestError(
                f"decode request rejected: prompt={len(prompt)} tokens + "
                f"max_new={max_new} exceeds max_len="
                f"{self.model.max_len} (or is empty) — oversized streams "
                "are rejected, never compiled")
            err.retryable = False
            err.tenant = tenant
            raise err
        deadline_ms = cfg.default_deadline_ms if deadline_ms is None \
            else deadline_ms
        deadline_s = None if deadline_ms is None or deadline_ms <= 0 \
            else deadline_ms / 1000.0
        stream = DecodeStream(prompt, max_new, deadline_s, tenant,
                              cfg.result_timeout_s)
        if not cfg.queue_on_busy:
            free = sum(1 for s in self._slots if s is None)
            queued = self._queue.qsize()
            if free == 0 or queued > 0:
                with self._lock:
                    self.counters["shed"] += 1
                raise SlotsExhausted(cfg.slots, queued=queued,
                                     tenant=tenant)
        try:
            with self._admit_lock:
                stopped = self._closed
                if not stopped:
                    self._queue.put_nowait(stream)
        except queue.Full:
            with self._lock:
                self.counters["shed"] += 1
            get_journal().event("decode_shed", engine=self._id,
                                depth=self._queue.qsize(),
                                limit=cfg.max_queue, tenant=tenant)
            raise ServerOverloaded(self._queue.qsize(), cfg.max_queue,
                                   tier="decode_queue",
                                   tenant=tenant) from None
        if stopped:
            raise ServerStopped("decode engine is stopping")
        return stream

    def generate(self, tokens, max_new_tokens=None, deadline_ms=None,
                 timeout_s=None, tenant=None):
        """Synchronous convenience: submit + wait → token list."""
        return self.submit(tokens, max_new_tokens=max_new_tokens,
                           deadline_ms=deadline_ms,
                           tenant=tenant).result(timeout_s)

    def occupancy(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {"slots": self.config.slots,
                "occupied": self.occupancy(),
                "queue_depth": self.queue_depth(),
                "programs": sorted("/".join(str(p) for p in k)
                                   for k in self._programs),
                "grid_bound": self.grid.grid_bound(),
                "step_ms": self.step_latency.summary(),
                **counters}

    # -- worker ----------------------------------------------------------
    def _run(self):
        j = get_journal()
        draining = False
        try:
            while True:
                if self._stopping.is_set():
                    break
                draining = self._admit(draining)
                active = [i for i, s in enumerate(self._slots)
                          if s is not None]
                if not active:
                    if draining and self._queue.qsize() == 0:
                        break
                    if not draining:
                        # idle: block (bounded) for the first stream
                        try:
                            item = self._queue.get(
                                timeout=self.config.window_ms / 1000.0)
                        except queue.Empty:
                            continue
                        if item is _STOP:
                            draining = True
                            continue
                        self._admit_one(item)
                    continue
                self._step(active)
        except BaseException as exc:        # the worker must die loudly
            j.crash(exc, where="decode_worker")
            raise
        finally:
            leftovers = [s for s in self._slots if s is not None]
            self._slots = [None] * self.config.slots
            self._drain_queue(leftovers)
            self._fail_streams(leftovers)

    def _drain_queue(self, out):
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not _STOP:
                out.append(item)

    def _fail_streams(self, streams):
        for s in streams:
            s._fail(ServerStopped("decode engine stopped before this "
                                  "stream finished"))
        streams.clear()

    def _admit(self, draining):
        """Fill free slots from the queue without waiting. Returns the
        updated draining flag."""
        while any(s is None for s in self._slots):
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return draining
            if item is _STOP:
                draining = True
                continue
            self._admit_one(item)
        return draining

    def _admit_one(self, stream):
        now = time.monotonic()
        if stream.cancelled():
            with self._lock:
                self.counters["cancelled"] += 1
            get_journal().event("decode_cancel", engine=self._id,
                                stage="queued", generated=0,
                                tenant=stream.tenant)
            stream._fail(RequestError("decode stream cancelled before "
                                      "admission"), now)
            stream.error.retryable = False
            return
        if stream.expired(now):
            with self._lock:
                self.counters["preempted"] += 1
            get_journal().event("decode_deadline_miss", engine=self._id,
                                stage="admit",
                                late_ms=round(stream.late_ms(now), 2),
                                tenant=stream.tenant)
            stream._fail(DeadlineExceeded("decode_admit",
                                          stream.late_ms(now),
                                          tenant=stream.tenant), now)
            return
        slot = self._slots.index(None)
        t0 = time.perf_counter()
        chunks = self._prefill(slot, stream.prompt[:-1])
        stream.slot = slot
        stream.admit_t = now
        self._slots[slot] = stream
        with self._lock:
            self.counters["admitted"] += 1
        get_journal().event(
            "decode_admit", engine=self._id, slot=slot,
            prompt=len(stream.prompt), chunks=chunks,
            max_new=stream.max_new, occupancy=self.occupancy(),
            queue_depth=self.queue_depth(), tenant=stream.tenant,
            prefill_ms=round((time.perf_counter() - t0) * 1000.0, 2))

    def _prefill(self, slot, toks) -> int:
        """Absorb a prompt prefix into ``slot`` in padded chunks on the
        prefill lattice; the first chunk has ``start == 0`` and resets
        the slot (a single-token prompt runs one empty chunk). Returns
        the chunk count."""
        chunk = self.config.prefill_chunk
        off, chunks = 0, 0
        while True:
            take = min(chunk, len(toks) - off)
            if chunks and take <= 0:
                break
            take = max(take, 0)
            bucket = self.prefill_buckets[0]
            for b in self.prefill_buckets:
                if take <= b:
                    bucket = b
                    break
            padded = np.zeros((bucket,), np.int32)
            padded[:take] = toks[off:off + take]
            prog = self._program(("prefill", bucket))
            with self._run_lock:
                prog(slot=slot, tokens=padded, length=take, start=off)
            off += take
            chunks += 1
            if off >= len(toks):
                break
        return chunks

    def _step(self, active):
        """One continuous-batching step: sweep cancels and deadlines, run
        the ``(slots, 1)`` program, hand out tokens, finish and free."""
        cfg = self.config
        now = time.monotonic()
        live = []
        for i in active:
            s = self._slots[i]
            if s.cancelled():
                self._slots[i] = None
                with self._lock:
                    self.counters["cancelled"] += 1
                get_journal().event("decode_cancel", engine=self._id,
                                    stage="active", slot=i,
                                    generated=len(s._generated),
                                    occupancy=self.occupancy(),
                                    tenant=s.tenant)
                err = RequestError(
                    f"decode stream cancelled after "
                    f"{len(s._generated)} tokens")
                err.retryable = False
                s._fail(err, now)
            elif s.expired(now):
                self._slots[i] = None
                with self._lock:
                    self.counters["preempted"] += 1
                get_journal().event("decode_preempt", engine=self._id,
                                    slot=i,
                                    late_ms=round(s.late_ms(now), 2),
                                    generated=len(s._generated),
                                    occupancy=self.occupancy(),
                                    tenant=s.tenant)
                s._fail(DeadlineExceeded("decode_step", s.late_ms(now),
                                         tenant=s.tenant), now)
            else:
                live.append(i)
        if not live:
            return
        toks = np.zeros((cfg.slots, 1), np.int32)
        mask = np.zeros((cfg.slots,), bool)
        for i in live:
            toks[i, 0] = self._slots[i].pending_tok
            mask[i] = True
        prog = self._program(("step",))
        t0 = time.perf_counter()
        with self._run_lock:
            nxt = prog(tokens=toks, active=mask).cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1000.0
        self.step_latency.observe(step_ms)
        finished = 0
        now = time.monotonic()
        for i in live:
            s = self._slots[i]
            tok = int(nxt[i])
            s._generated.append(tok)
            s.pending_tok = tok
            if len(s._generated) >= s.max_new:
                self._slots[i] = None
                finished += 1
                get_journal().event(
                    "decode_finish", engine=self._id, slot=i,
                    generated=len(s._generated),
                    ms=round((now - s.enq_t) * 1000.0, 2),
                    occupancy=self.occupancy(), tenant=s.tenant)
                s._finish(now)
        with self._lock:
            self.counters["steps"] += 1
            self.counters["tokens_out"] += len(live)
            self.counters["completed"] += finished
        lat = self.step_latency.summary()
        get_journal().event(
            "decode_step", engine=self._id, active=len(live),
            slots=cfg.slots,
            occupancy=round(len(live) / cfg.slots, 4),
            step_ms=round(step_ms, 3), finished=finished,
            queue_depth=self.queue_depth(),
            p50_ms=lat["p50"], p95_ms=lat["p95"])


def _assign(state, new):
    """Write a model function's new state into the resident tensors."""
    for k, v in new.items():
        if v is not state[k]:
            state[k].copy_(v)
