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
``timer`` (carries ``dur_s``) and ``crash`` (an exception record).

The sink is ``MXNET_TPU_JOURNAL``: ``stderr`` (the default, looked up at
each write so a swapped stream is followed), a file path (appended to)
or ``off``. A bounded ring of the latest records is kept in memory
whatever the sink (:meth:`Journal.recent`). A failed sink write drops
the line and counts it (``write_drops``); it never raises into the
caller.

Import-light: stdlib only.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import traceback
from collections import deque

__all__ = ["Journal", "get_journal", "reset_journal"]

RECENT_CAP_DEFAULT = 256


class Journal:
    """Append-only JSONL event log with phase tracking."""

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
        try:
            cap = int(os.environ.get("MXNET_TPU_JOURNAL_RECENT",
                                     RECENT_CAP_DEFAULT))
        except ValueError:
            cap = RECENT_CAP_DEFAULT
        self._recent: deque = deque(maxlen=max(cap, 1))
        self.write_drops = 0

    def event(self, kind: str, **fields) -> dict:
        """Write one JSON line, flushed at once. Returns the record."""
        rec = {"ts": round(time.time(), 3),
               "up_s": round(time.monotonic() - self._t0_mono, 3),
               "kind": kind, "phase": self._last_phase}
        rec.update(fields)
        line = None if self._off else json.dumps(rec, default=str)
        with self._lock:
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
                self.write_drops += 1
        return rec

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
