"""Crash flight recorder — the postmortem ring that survives the kill
(counterpart of ``mxnet_tpu/observability/flight.py``; the same dump
document).

A pod drill's most valuable process is the one that can no longer be
asked: the SIGKILLed replica, the wedged rank its launcher timed out.
This module keeps the two always-on bounded rings the runtime already
maintains — the tracer's span ring (observability/trace.py) and the
journal's recent-records ring (diagnostics/journal.py) — and writes
them, plus a clock-alignment anchor and the pod identity block, as ONE
atomic JSON dump other processes can read after this one is gone::

    <out_dir>/flight-<label>.json

Dump triggers (the existing diagnostics hooks, per the journal/watchdog
contracts):

- **SIGTERM / normal exit** — ``journal.install_handlers`` finalizer
  (reason ``sigterm``/``atexit``);
- **crash** — the finalizer again: an unhandled exception reaches
  atexit with the crash record already in the journal ring;
- **wedge** — the watchdog's stall hook (reason ``stall``), captured
  BEFORE the supervisor's outer kill lands;
- **SIGKILL** — nothing runs, so the recorder also flushes
  periodically (``MXNET_TPU_TRACE_FLIGHT_S``, default 2 s): the last
  periodic dump IS the postmortem, at most one flush interval stale.

Every dump is a whole-file atomic replace (``resilience.atomic``), so a
kill mid-flush leaves the previous complete dump, never half a JSON.
``observability/aggregate.py`` folds flight dumps into the merged
cross-process trace exactly like journal span records — the killed
replica's tail appears on the shared timeline.

Knobs: ``MXNET_TPU_TRACE_DIR`` (the shared-FS run
directory; unset = recorder off), ``MXNET_TPU_TRACE_FLIGHT_S``
(periodic flush interval; ``0`` disables the periodic thread, dumps
still fire on the event hooks).

Stdlib only. The periodic thread makes no CUDA call: a dump reads the
host-side rings, so it can neither synchronize the device nor disturb a
graph capture on another thread.
"""
from __future__ import annotations

import json
import os
import threading

from ..diagnostics import watchdog as _watchdog
from ..diagnostics.journal import get_journal
from . import trace as _trace

__all__ = ["FlightRecorder", "DEFAULT_FLUSH_S", "flight_path",
           "install_from_env", "read_flight"]

DEFAULT_FLUSH_S = 2.0
DUMP_SPANS_CAP = 512          # last-N spans per dump (bounded file size)


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _label() -> str:
    """Stable per-process dump label: replica id when the pool stamped
    one, else rank-qualified pid — two processes of one pod can never
    clobber each other's dump file."""
    ident = _trace.identity()
    if ident.get("replica") is not None:
        return f"replica-{ident['replica']}"
    return f"rank{ident['rank']}-pid{ident['pid']}"


def flight_path(out_dir, label=None) -> str:
    return os.path.join(str(out_dir), f"flight-{label or _label()}.json")


def read_flight(path) -> dict:
    """Load one dump (the aggregator/tests' reader).  Raises OSError /
    ValueError on an unreadable file — callers decide what a missing
    postmortem means."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("kind") != "flight":
        raise ValueError(f"{path} is not a flight-recorder dump")
    return doc


class FlightRecorder:
    """One process's dump writer: event-hook dumps + optional periodic
    flush.  ``install()`` wires the diagnostics hooks; ``stop(dump=
    True)`` writes the clean-exit dump and detaches the wedge hook."""

    def __init__(self, out_dir, label=None, flush_s=None, journal=None):
        self.out_dir = str(out_dir)
        self.label = label or _label()
        self.flush_s = (_env_float("MXNET_TPU_TRACE_FLIGHT_S",
                                   DEFAULT_FLUSH_S)
                        if flush_s is None else float(flush_s))
        self._journal = journal if journal is not None else get_journal()
        self._stop = threading.Event()
        self._thread = None
        self._installed = False
        self._on_stall = lambda: self.dump("stall")
        self._on_final = lambda: self.dump("final")
        self.dumps = 0
        self.drops = 0

    @property
    def path(self) -> str:
        return flight_path(self.out_dir, self.label)

    MAX_PREV = 3

    def _rotate_existing(self) -> None:
        """A fresh incarnation must not clobber its predecessor's
        postmortem: a respawned replica reuses the label, so the
        existing dump rotates to ``flight-<label>.prev-1.json`` (a
        bounded history — the aggregator folds the prevs into the same
        process identity by their own anchors)."""
        path = self.path
        if not os.path.exists(path):
            return
        base = path[:-len(".json")]
        try:
            for n in range(self.MAX_PREV, 1, -1):
                older = f"{base}.prev-{n - 1}.json"
                if os.path.exists(older):
                    os.replace(older, f"{base}.prev-{n}.json")
            os.replace(path, f"{base}.prev-1.json")
        except OSError:
            pass             # rotation is best-effort; dumping must win

    # -- the dump --------------------------------------------------------
    def dump(self, reason: str) -> str | None:
        """Write the rings atomically; returns the path (None when the
        write failed — a flight recorder must never take the plane
        down with it)."""
        tracer = _trace.get_tracer()
        spans = tracer.spans()
        doc = {"kind": "flight", "reason": reason, "label": self.label,
               "seq": self.dumps + 1,
               "anchor": _trace.anchor_doc(tracer),
               "trace": tracer.stats(),
               "spans": spans[-DUMP_SPANS_CAP:],
               "journal_tail": self._journal.recent(),
               "last_phase": self._journal.last_phase,
               **_trace.identity()}
        try:
            from ..resilience.atomic import atomic_write
            os.makedirs(self.out_dir, exist_ok=True)
            with atomic_write(self.path, "w", durable=False) as f:
                json.dump(doc, f, default=str)
        except (OSError, ValueError) as exc:
            self._note_drop(exc)
            return None
        self.dumps += 1
        return self.path

    def _note_drop(self, exc) -> None:
        """A dump write failed (full/unwritable run dir): degrade to
        drop-and-count — bump the drops metric, journal ONE marker per
        recorder (the journal itself degrades under the same disk), and
        keep flying.  The previous complete dump stays on disk."""
        self.drops += 1
        try:
            from .metrics import default_registry
            default_registry().counter(
                "mxnet_tpu_flight_dump_drops_total",
                "flight-recorder dumps dropped because the run-dir "
                "write failed (full/unwritable disk)").inc()
        except Exception:
            pass                 # accounting must never ground the recorder
        if self.drops == 1:
            self._journal.event("flight_dump_failed", path=self.path,
                                error=type(exc).__name__,
                                detail=str(exc)[:200])

    # -- lifecycle -------------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Wire the diagnostics hooks (idempotent): the journal's
        SIGTERM/atexit finalizer and the watchdog's stall callback; then
        start the periodic flush thread (when ``flush_s > 0``)."""
        if self._installed:
            return self
        self._installed = True
        self._rotate_existing()
        # final_cb fires on SIGTERM/atexit UNLESS mark_clean() was
        # called — but a clean exit should keep its dump too, so the
        # worker calls stop(dump=True) explicitly on its shutdown path
        # (stop also UNREGISTERS this callback: the exit-time "final"
        # dump must not overwrite the clean "stop" one)
        self._journal.install_handlers(final_cb=self._on_final)
        _watchdog.add_stall_callback(self._on_stall)
        if self.flush_s > 0:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"mxnet-torch-flight-{self.label}")
            self._thread.start()
        self._journal.event("flight_recorder_start", path=self.path,
                            flush_s=self.flush_s)
        return self

    def _run(self):
        while not self._stop.wait(self.flush_s):
            self.dump("periodic")

    def stop(self, dump=True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.flush_s + 5.0)
            self._thread = None
        _watchdog.remove_stall_callback(self._on_stall)
        self._journal.remove_final_cb(self._on_final)
        self._installed = False      # a later install() rewires cleanly
        if dump:
            self.dump("stop")


def install_from_env(journal=None) -> FlightRecorder | None:
    """Start a recorder when ``MXNET_TPU_TRACE_DIR`` names a run
    directory; None (and zero cost) otherwise — the always-off default
    keeps the off-is-free contract for processes outside a pod run."""
    out_dir = os.environ.get("MXNET_TPU_TRACE_DIR")
    if not out_dir:
        return None
    return FlightRecorder(out_dir, journal=journal).install()
