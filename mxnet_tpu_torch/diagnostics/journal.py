"""Structured event journal: append-only JSONL records (counterpart of
``mxnet_tpu/diagnostics/journal.py``).

Every record is one JSON line, written and flushed at once, so the tail
of a killed process's sink still names its last phase. The training
guardrails write their ``nonfinite_grad``, ``loss_spike``,
``divergence_rollback`` (step, restored_step, reason, lr_backoff,
rollback, max_rollbacks, consumer) and ``guard_poll`` records here, and
``guardrails.guard_report`` reads them back. The checkpoint family
writes ``ckpt_committed`` and ``ckpt_skip_existing`` (root, step),
``ckpt_fallback`` (root, step, detail: why the step was skipped),
``ckpt_restored`` (root, step), ``reshard_restore`` (root, step, n_old,
n_new, entries, bytes, consumer), ``rng_not_restored`` (a checkpoint's
generator state of another implementation, left alone), and
``resilience`` its ``retry``, ``disk_full`` and ``fsync_dir_failed``
records, with the reference's fields. The server's hot reload writes
``serving_reload`` (step, n_params, prev_step, and the port's load_s,
apply_s and bytes), ``serving_reload_failed`` (step, error, detail) and,
through ``serving.ParamStore``, ``ckpt_fallback`` with ``consumer``
"serving".

Record schema (all records)::

    {"ts": <unix s>, "up_s": <s since journal start>, "kind": <str>,
     "phase": <innermost active phase>, ...kind-specific fields}

Kinds written by this module: ``phase_enter`` / ``phase_exit`` (paired,
the exit carries ``dur_s``), ``phase`` (:meth:`Journal.set_phase`),
``timer`` (carries ``dur_s``), ``crash`` (an exception record) and
``final`` (the SIGTERM/atexit breadcrumb of :meth:`Journal.install_handlers`,
with ``last_phase`` and ``reason``). The watchdog writes ``heartbeat``
and ``stall``.

The sink is ``MXNET_TPU_JOURNAL``: ``stderr`` (the default, looked up at
each write so a swapped stream is followed), a file path (appended to)
or ``off``. A bounded ring of the latest records is kept in memory
whatever the sink (:meth:`Journal.recent`, the flight recorder's journal
half; heartbeats stay out of it). A failed sink write drops the line and
counts it (``write_drops`` and, once the metrics registry is loaded,
``mxnet_tpu_journal_write_drops_total``, with one note on stderr); it
never raises into the caller.

Records written inside an open trace span carry its ``trace_id`` and
``span_id``: ``observability.trace`` registers the provider
(:func:`set_trace_ids_provider`); with tracing off the records are
unchanged.

Import-light: stdlib only.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque

__all__ = ["Journal", "get_journal", "reset_journal",
           "set_trace_ids_provider"]

RECENT_CAP_DEFAULT = 256

# the correlation hook: observability.trace registers its current_ids()
# here (a slot, not an import, so this module stays stdlib only)
_trace_ids_provider = None


def set_trace_ids_provider(fn) -> None:
    global _trace_ids_provider
    _trace_ids_provider = fn


class Journal:
    """Append-only JSONL event log with phase tracking and exit
    handlers."""

    def __init__(self, path: str | None = None):
        if path is None:
            path = os.environ.get("MXNET_TPU_JOURNAL", "stderr")
        self.path = path
        self._fh = None
        self._off = path == "off"
        if path not in ("stderr", "off"):
            self._fh = open(path, "a", buffering=1)
        self._lock = threading.RLock()
        # wall clock for ts only; up_s is monotonic, so a clock step
        # cannot make it run backwards
        self._t0_mono = time.monotonic()
        self._phase_stack: list[str] = []
        self._last_phase = "startup"
        # monotonic time of the last non-heartbeat record: the
        # watchdog's notion of progress
        self.last_activity = time.monotonic()
        self._handlers_installed = False
        self._final_cbs: list = []
        self._final_done = False
        self._clean = False
        try:
            cap = int(os.environ.get("MXNET_TPU_JOURNAL_RECENT",
                                     RECENT_CAP_DEFAULT))
        except ValueError:
            cap = RECENT_CAP_DEFAULT
        self._recent: deque = deque(maxlen=max(cap, 1))
        self.write_drops = 0
        self._drops_uncounted = 0
        self._drop_noted = False

    def event(self, kind: str, _heartbeat: bool = False, **fields) -> dict:
        """Write one JSON line, flushed at once. Returns the record.
        ``_heartbeat`` records (the watchdog's) stay out of the recent
        ring and do not count as progress."""
        rec = {"ts": round(time.time(), 3),
               "up_s": round(time.monotonic() - self._t0_mono, 3),
               "kind": kind, "phase": self._last_phase}
        rec.update(fields)
        if _trace_ids_provider is not None:
            try:
                ids = _trace_ids_provider()
            except Exception:
                ids = None
            if ids:
                for k, v in ids.items():
                    rec.setdefault(k, v)
        line = None if self._off else json.dumps(rec, default=str)
        with self._lock:
            if not _heartbeat:
                self._recent.append(rec)
            if line is None:
                return rec
            try:
                fh = self._fh if self._fh is not None else sys.stderr
                fh.write(line + "\n")
                fh.flush()
            except (ValueError, OSError):
                # a full disk or a closed stream costs the line, never
                # the caller's step
                self._note_write_drop()
            if not _heartbeat:
                self.last_activity = time.monotonic()
        return rec

    def _note_write_drop(self) -> None:
        """Count one failed sink write (the caller holds the lock): into
        ``mxnet_tpu_journal_write_drops_total`` when the metrics registry
        is already loaded (this module imports nothing), and one note on
        stderr per sink."""
        self.write_drops += 1
        self._drops_uncounted += 1
        mod = sys.modules.get("mxnet_tpu_torch.observability.metrics")
        if mod is not None:
            try:
                mod.default_registry().counter(
                    "mxnet_tpu_journal_write_drops_total",
                    "journal records dropped because the sink write "
                    "failed (full/unwritable disk or closed stream)",
                ).inc(self._drops_uncounted)
                self._drops_uncounted = 0
            except Exception:
                pass             # accounting must never crash the journal
        if not self._drop_noted:
            self._drop_noted = True
            try:
                sys.stderr.write(
                    f"mxnet_tpu: journal sink {self.path!r} unwritable; "
                    "dropping records (see "
                    "mxnet_tpu_journal_write_drops_total)\n")
            except (ValueError, OSError):
                pass             # stderr itself may be the dead sink

    def recent(self) -> list:
        """The latest records, oldest first."""
        with self._lock:
            return list(self._recent)

    @property
    def last_phase(self) -> str:
        return self._last_phase

    def set_phase(self, name: str) -> None:
        """Mark a phase of a linear script: one ``phase`` record."""
        self._last_phase = name
        self.event("phase")

    @contextlib.contextmanager
    def phase(self, name: str):
        """A paired phase: ``phase_enter``, then ``phase_exit`` with
        ``dur_s``; an exception is journaled as ``crash`` and re-raised.
        Nested phases restore the outer one."""
        with self._lock:
            self._phase_stack.append(name)
            self._last_phase = name
        self.event("phase_enter")
        t0 = time.perf_counter()
        try:
            yield self
        except BaseException as exc:
            self.crash(exc)
            raise
        finally:
            self.event("phase_exit",
                       dur_s=round(time.perf_counter() - t0, 3))
            with self._lock:
                if self._phase_stack and self._phase_stack[-1] == name:
                    self._phase_stack.pop()
                self._last_phase = (self._phase_stack[-1]
                                    if self._phase_stack else "after:" + name)

    @contextlib.contextmanager
    def timer(self, name: str):
        """One ``timer`` record with ``dur_s`` when the scope ends."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event("timer", name=name,
                       dur_s=round(time.perf_counter() - t0, 3))

    def crash(self, exc: BaseException, **fields) -> dict:
        """A ``crash`` record: exception type, message and traceback."""
        tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))[-4000:]
        return self.event("crash", error=type(exc).__name__,
                          detail=str(exc)[:500], traceback=tb, **fields)

    # -- exit breadcrumbs ----------------------------------------------------
    def mark_clean(self) -> None:
        """Declare the run complete: the ``final`` record is still written
        at exit, but the registered final callbacks are not run."""
        self._clean = True

    def install_handlers(self, final_cb=None) -> None:
        """Register ``SIGTERM`` and ``atexit`` finalizers that write a
        ``final`` record with the last phase. ``final_cb`` (a callable)
        runs once at finalization unless :meth:`mark_clean` was called;
        callbacks of repeated calls accumulate."""
        if final_cb is not None:
            self._final_cbs.append(final_cb)
        if self._handlers_installed:
            return
        self._handlers_installed = True
        atexit.register(self._finalize, "atexit")
        try:                       # signals bind in the main thread only
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                self._finalize("sigterm")
                if callable(prev):
                    prev(signum, frame)
                elif prev != signal.SIG_IGN:
                    # the default disposition, re-delivered, so the exit
                    # status still says "terminated by SIGTERM"
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass

    def remove_final_cb(self, final_cb) -> None:
        """Unregister a callback of :meth:`install_handlers`: its owner
        shut down cleanly and wrote its own record."""
        try:
            self._final_cbs.remove(final_cb)
        except ValueError:
            pass

    def _finalize(self, reason: str) -> None:
        if self._final_done:
            return
        self._final_done = True
        self.event("final", reason=reason, last_phase=self._last_phase,
                   clean=self._clean)
        if not self._clean:
            for cb in self._final_cbs:
                try:
                    cb()
                except Exception:
                    pass

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
            self._off = True


_global_lock = threading.Lock()
_global: Journal | None = None


def get_journal() -> Journal:
    """The process-wide journal (sink from ``MXNET_TPU_JOURNAL``)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Journal()
        return _global


def reset_journal(path: str | None = None) -> Journal:
    """Replace the process-wide journal, closing the old one's file."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.close()
        _global = Journal(path)
        return _global
