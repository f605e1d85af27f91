"""Span tracing (counterpart of ``mxnet_tpu/observability/trace.py``,
with its names, knobs and record schemas).

A ``span(name, **attrs)`` context manager with process-unique trace and
span ids, explicit parent propagation across threads (the serving
worker, the router's hedge arms, the flight recorder), rank and replica
tagging, and monotonic durations, recorded into a bounded in-memory
ring and, in journal mode, streamed to the diagnostics journal as
``kind="span"`` records.

Off is cheap: with tracing disabled :func:`span` returns ONE shared
no-op object. In no mode does a span read the device: attributes are
host scalars (ints, strings, shape tuples), and no site calls
``.item()``, ``.cpu()``, ``.tolist()`` or a synchronize. On the card two
more rules place the spans:

- a CUDA graph replays no Python, so a span inside a captured function
  fires once, at capture; the sites therefore wrap the host call that
  replays a graph, never the function it captures;
- CUDA is asynchronous, so a span around a launch times the enqueue; a
  span covers the card's time only where the host already waits for a
  result (the serving ``execute`` span ends after the outputs reach the
  host).

Knobs::

    MXNET_TPU_TRACE       off (default) | ring | journal
                          ring    = bounded in-memory ring only
                          journal = ring + one JSONL record per span
    MXNET_TPU_TRACE_RING  ring capacity in spans (default 4096)

Pod attribution: spans carry the process rank (``MXTPU_PROC_ID``) and
the serving replica (``MXNET_TPU_REPLICA_ID``, stamped by the replica
pool into each worker's environment); anchor and flight records also
carry the pod run id (``MXNET_TPU_POD_RUN_ID``). Journal mode writes one
``trace_anchor`` record pairing the wall clock with this process's
``perf_counter`` timeline, the alignment point of
``observability/aggregate.py``.

Stdlib only.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque

__all__ = ["MODES", "Span", "SpanContext", "Tracer", "adopt_trace",
           "annotate", "configure", "current_context", "current_ids",
           "current_span", "enabled", "event", "get_tracer", "identity",
           "mode", "record", "reset_tracer", "span", "start_span"]

MODES = ("off", "ring", "journal")
DEFAULT_RING = 4096
DROPS_METRIC = "mxnet_tpu_trace_ring_drops_total"


def anchor_doc(tracer=None) -> dict:
    """The clock-alignment payload (shared by the journal
    ``trace_anchor`` record and the flight-recorder dump): an atomic
    wall/perf_counter sample pair, the tracer's span-timeline epoch, and
    the pod identity block."""
    tracer = tracer if tracer is not None else get_tracer()
    return {"wall_s": round(time.time(), 6),
            "perf_s": round(time.perf_counter(), 6),
            "epoch_s": round(tracer.epoch, 6), **identity()}

# process-unique trace-id prefix: two traces from two processes (multi-
# host ranks sharing one journal file) can never collide
_PROC_TOKEN = os.urandom(4).hex()
_ids = itertools.count(1)            # GIL-atomic; one sequence per process


def _rank() -> int:
    """Process rank for span tagging, from the environment
    (``MXTPU_PROC_ID``), never from a device call."""
    try:
        return int(os.environ.get("MXTPU_PROC_ID", "0"))
    except ValueError:
        return 0


def _replica():
    """Serving-replica identity for span tagging — the replica pool
    stamps ``MXNET_TPU_REPLICA_ID`` into every worker's environment so
    two replicas that share a rank (two workers on one host) stay
    distinguishable in a merged trace (the Perfetto pid-collision fix).
    None outside a pool worker."""
    return os.environ.get("MXNET_TPU_REPLICA_ID") or None


def identity() -> dict:
    """This process's pod-attribution block: rank, replica (when the
    pool stamped one), pid, and the pod run id — the fields anchor and
    flight-recorder records carry so ``observability/aggregate.py`` can
    attribute every per-process file (docs/observability.md)."""
    doc = {"rank": _rank(), "pid": os.getpid()}
    rep = _replica()
    if rep is not None:
        doc["replica"] = rep
    run_id = os.environ.get("MXNET_TPU_POD_RUN_ID")
    if run_id:
        doc["run_id"] = run_id
    return doc


class SpanContext:
    """The cross-thread propagation token: just the two IDs.  Capture
    with :func:`current_context` on the submitting thread, pass as
    ``span(..., parent=ctx)`` on the worker thread."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


class Span:
    """One timed scope.  Created by :func:`span`/:func:`start_span`;
    durations come from ``time.perf_counter`` (monotonic — wall-clock
    steps under NTP cannot produce negative durations, the G11 class)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "rank", "replica", "thread", "t0", "dur_s", "_token",
                 "_ended")

    def __init__(self, name, trace_id, parent_id, attrs, t0=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{next(_ids):08x}"
        self.parent_id = parent_id
        self.attrs = attrs
        self.rank = _rank()
        self.replica = _replica()
        self.thread = threading.current_thread().name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.dur_s = None
        self._token = None
        self._ended = False

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attrs(self, **attrs):
        self.attrs.update(attrs)

    def end(self, _t1=None, **attrs) -> "Span":
        """Close a manually-started span (cross-thread lifecycles — the
        serving request root); idempotent so error paths can race the
        success path without double-recording."""
        if self._ended:
            return self
        self._ended = True
        if attrs:
            self.attrs.update(attrs)
        self.dur_s = (time.perf_counter() if _t1 is None else _t1) - self.t0
        get_tracer()._record(self)
        return self

    # -- context-manager protocol (the common single-thread case) ------------
    def __enter__(self):
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False

    def to_dict(self) -> dict:
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "start_s": round(self.t0 - get_tracer().epoch, 6),
             "dur_s": (round(self.dur_s, 6)
                       if self.dur_s is not None else None),
             "rank": self.rank, "thread": self.thread}
        if self.replica is not None:
            d["replica"] = self.replica
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NoopSpan:
    """The disabled tier: one shared instance, every operation a no-op.
    ``trace_id``/``span_id`` are None so ``current_ids()`` consumers can
    treat it uniformly."""

    __slots__ = ()
    trace_id = span_id = parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attrs(self, **attrs):
        pass

    def end(self, **attrs):
        return self

    def context(self):
        return None


_NOOP = _NoopSpan()
_current: contextvars.ContextVar = contextvars.ContextVar(
    "mxnet_tpu_torch_current_span", default=None)


class Tracer:
    """Process-wide span sink: a bounded ring plus optional journal
    streaming.  ``mode`` resolves from ``MXNET_TPU_TRACE`` at
    construction; :func:`configure` replaces the tracer (tests, programs
    that flip tracing on mid-process)."""

    def __init__(self, mode=None, ring=None):
        if mode is None:
            raw = os.environ.get("MXNET_TPU_TRACE", "off").strip().lower()
            mode = raw if raw in MODES else "off"
            if raw and raw not in MODES and raw != "off":
                self._bad_mode = raw     # journaled below, once
            else:
                self._bad_mode = None
        else:
            if mode not in MODES:
                raise ValueError(f"trace mode must be one of {MODES}; "
                                 f"got {mode!r}")
            self._bad_mode = None
        if ring is None:
            try:
                ring = int(os.environ.get("MXNET_TPU_TRACE_RING",
                                          DEFAULT_RING))
            except ValueError:
                ring = DEFAULT_RING
        self.mode = mode
        self.ring_size = max(int(ring), 1)
        self.epoch = time.perf_counter()    # span timeline origin
        self._ring: deque = deque(maxlen=self.ring_size)
        self._lock = threading.Lock()
        self.recorded = 0
        self.dropped = 0
        # one clock-alignment anchor per journal-mode tracer: written by
        # journal_startup() (after the tracer lock releases, like the
        # bad-mode note) so the aggregator can map this process's
        # perf_counter span timeline onto the shared wall clock
        self._anchor_pending = mode == "journal"

    def journal_startup(self) -> None:
        """Journal the once-per-tracer startup records — a rejected
        ``MXNET_TPU_TRACE`` value and, in journal mode, the
        ``trace_anchor`` clock-alignment record.  A separate step (not
        ``__init__``) because construction happens under
        ``_tracer_lock`` and the journal is file I/O no lock may hold
        across (G15); get_tracer/configure call this after release."""
        with self._lock:     # claim-once: two first-users must not
            bad = self._bad_mode          # both journal the same note
            self._bad_mode = None
            anchor = self._anchor_pending
            self._anchor_pending = False
        if bad is not None:
            from ..diagnostics.journal import get_journal
            get_journal().event(
                "trace_bad_mode", value=bad,
                detail=f"MXNET_TPU_TRACE={bad!r} not in "
                       f"{MODES}; tracing stays off")
        if anchor:
            self.journal_anchor()

    def journal_anchor(self) -> dict:
        """Write this process's clock-alignment anchor: one wall-clock /
        perf_counter sample pair plus the tracer epoch and the pod
        identity block.  The aggregator computes ``wall = wall_s -
        perf_s + epoch_s + span.start_s`` from it — intra-process span
        precision stays monotonic, only ONE wall sample is trusted per
        process (the G11 discipline applied across processes)."""
        from ..diagnostics.journal import get_journal
        return get_journal().event("trace_anchor", **anchor_doc(self))

    def _record(self, sp: Span) -> None:
        d = sp.to_dict()
        with self._lock:
            if len(self._ring) == self.ring_size:
                self.dropped += 1
                dropped = self.dropped
            else:
                dropped = None
            self._ring.append(d)
            self.recorded += 1
        if dropped is not None:
            self._note_drop(dropped)
        if self.mode == "journal":
            from ..diagnostics.journal import get_journal
            get_journal().event("span", **d)

    def _note_drop(self, dropped: int) -> None:
        """Ring-overflow accounting (outside the ring lock): bump the
        ``mxnet_tpu_trace_ring_drops_total`` metric family, and journal
        a marker on the first drop (then every 1000th) so silent span
        loss under load is visible in ``doctor --trace`` without a
        per-drop journal write."""
        try:
            from .metrics import default_registry
            default_registry().counter(
                DROPS_METRIC,
                "spans dropped from the bounded trace ring "
                "(raise MXNET_TPU_TRACE_RING)").inc()
        except Exception:
            pass                     # accounting must never kill tracing
        if dropped == 1 or dropped % 1000 == 0:
            from ..diagnostics.journal import get_journal
            get_journal().event("trace_ring_drops", dropped=dropped,
                                ring_size=self.ring_size)

    def spans(self) -> list:
        """Snapshot of the ring (oldest first), as plain dicts."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"mode": self.mode, "ring_size": self.ring_size,
                    "in_ring": len(self._ring),
                    "recorded": self.recorded, "dropped": self.dropped}


_tracer_lock = threading.Lock()
_tracer: Tracer | None = None


def get_tracer() -> Tracer:
    global _tracer
    # lock-free fast path: span() runs on every instrumented hot-path
    # call, and a populated module global is safe to read un-locked
    t = _tracer
    if t is not None:
        return t
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer()
        t = _tracer
    t.journal_startup()             # journal I/O: after the lock
    return t


def configure(mode=None, ring=None) -> Tracer:
    """Replace the process tracer (explicit mode beats the env knob).
    Returns the new tracer."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(mode=mode, ring=ring)
        t = _tracer
    t.journal_startup()             # journal I/O: after the lock
    return t


def reset_tracer() -> Tracer:
    """Re-resolve from the environment (tests)."""
    return configure(mode=None, ring=None)


def mode() -> str:
    return get_tracer().mode


def enabled() -> bool:
    return get_tracer().mode != "off"


# -- span creation ----------------------------------------------------------

def _parent_of(parent):
    """(trace_id, parent_span_id) for a new span: explicit parent
    (Span/SpanContext) wins, else the context-local current span, else a
    fresh trace root."""
    if parent is None:
        parent = _current.get()
    if parent is None or parent is _NOOP:
        return f"{_PROC_TOKEN}{next(_ids):06x}", None
    return parent.trace_id, parent.span_id


def _new_span(name, parent, attrs, t0=None):
    """The ONE creation preamble every span flavor shares: off-mode
    fast path, parent resolution, Span construction."""
    if get_tracer().mode == "off":
        return _NOOP
    trace_id, parent_id = _parent_of(parent)
    return Span(name, trace_id, parent_id, attrs, t0=t0)


def span(name, parent=None, **attrs):
    """Open a traced scope::

        with trace.span("step", step=t) as sp:
            ...

    ``parent`` re-parents explicitly (a Span or SpanContext captured on
    another thread); default is the calling context's current span.
    Disabled tracing returns the shared no-op — near-zero cost, and by
    contract no host reads (pass only host scalars as attrs)."""
    return _new_span(name, parent, attrs)


def start_span(name, parent=None, **attrs):
    """Manually-managed span for lifecycles that cross threads (the
    serving request: opened at submit, ended by the worker).  Same
    creation semantics as :func:`span`, but only entered as the
    context-local current span if used as a context manager; close it
    with ``sp.end(**attrs)``."""
    return _new_span(name, parent, attrs)


def record(name, parent=None, t0=None, t1=None, **attrs):
    """Emit a completed span with explicit perf_counter endpoints — for
    work measured once but attributed to several traces (the serving
    batch's execution window, recorded under each request's root)."""
    return _new_span(name, parent, attrs, t0=t0).end(_t1=t1)


def event(name, parent=None, **attrs):
    """Zero-duration instant span (a point annotation on the timeline —
    the pallas dispatch decision, a reload)."""
    sp = _new_span(name, parent, attrs)
    return sp.end(_t1=sp.t0) if sp is not _NOOP else sp


def current_span():
    sp = _current.get()
    return sp if sp is not None else None


def current_context() -> SpanContext | None:
    """Capture token for cross-thread propagation (None outside any
    span or with tracing off)."""
    sp = _current.get()
    return sp.context() if sp is not None else None


def adopt_trace(sp, trace_id) -> bool:
    """Re-stamp an OPEN span onto another process's trace — the elastic
    recovery join: every survivor opens its own ``elastic_recover``
    span, the leader publishes its trace id through the epoch ledger,
    and survivors adopt it so the whole pod's recovery records share
    ONE trace (docs/elastic.md).  Only the span's trace lineage changes;
    child spans and journal records created AFTER adoption inherit the
    adopted id (``current_ids`` reads the live span).  No-op (False) on
    the disabled no-op span, a closed span, or a null/identical id."""
    if not trace_id or sp is None or sp is _NOOP:
        return False
    if getattr(sp, "_ended", True) or sp.trace_id == trace_id:
        return False
    sp.trace_id = trace_id
    return True


def annotate(**attrs) -> bool:
    """Attach attrs to the innermost active span, if any (the pallas
    dispatch hook).  No-op (False) when tracing is off or no span is
    open."""
    sp = _current.get()
    if sp is None:
        return False
    sp.set_attrs(**attrs)
    return True


def current_ids() -> dict:
    """``{"trace_id": ..., "span_id": ...}`` of the innermost active
    span, or ``{}`` — the journal correlation hook: every JSONL record
    written inside a span carries these two fields, so the historically
    separate journals (serving, guardrails, checkpoint fallback, pallas)
    correlate against one trace.  With tracing off this is always ``{}``
    and journal records stay bit-identical to the pre-trace schema."""
    sp = _current.get()
    if sp is None:
        return {}
    return {"trace_id": sp.trace_id, "span_id": sp.span_id}


# register the correlation hook: the journal must stay import-light (it
# cannot import this module), so it exposes a provider slot instead
from ..diagnostics import journal as _journal  # noqa: E402

_journal.set_trace_ids_provider(current_ids)
