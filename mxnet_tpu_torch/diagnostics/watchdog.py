"""Watchdog — heartbeat daemon + stall-triggered traceback dumps
(counterpart of ``mxnet_tpu/diagnostics/watchdog.py``).

A supervisor's outer ``timeout`` kill produces an information-free ``rc:124``
unless the process itself leaves breadcrumbs. The watchdog is a daemon
thread that:

1. emits an unbuffered one-line JSON ``heartbeat`` (phase, wall time,
   RSS) every ``interval_s`` — a tail of stderr/the journal file then
   shows the process was alive and *where* it was;
2. when no progress lands for ``stall_s`` (no journal activity and no
   explicit ``beat()``), dumps ``faulthandler`` tracebacks of ALL
   threads into a ``stall`` journal record — captured BEFORE the
   supervisor's kill, so the artifact pins the hang to a stack, not a guess.

Knobs: ``MXNET_TPU_HEARTBEAT_S`` (default 15), ``MXNET_TPU_STALL_S``
(default 120). Stdlib only: the thread makes no CUDA call, so it cannot
disturb a graph capture on another thread.
"""
from __future__ import annotations

import faulthandler
import os
import sys
import tempfile
import threading
import time

from .journal import Journal, get_journal

__all__ = ["Watchdog", "add_stall_callback", "remove_stall_callback"]

DEFAULT_INTERVAL_S = 15.0
DEFAULT_STALL_S = 120.0

# process-wide stall hooks: called (no args) once per stall episode by
# ANY running watchdog, right after its stall record lands.  The slot
# the observability flight recorder registers its wedge dump into —
# a provider slot, not an import, so this module stays import-light
_stall_callbacks: list = []
_stall_cb_lock = threading.Lock()


def add_stall_callback(fn) -> None:
    with _stall_cb_lock:
        if fn not in _stall_callbacks:
            _stall_callbacks.append(fn)


def remove_stall_callback(fn) -> None:
    with _stall_cb_lock:
        try:
            _stall_callbacks.remove(fn)
        except ValueError:
            pass


def _fire_stall_callbacks() -> None:
    with _stall_cb_lock:
        cbs = list(_stall_callbacks)
    for cb in cbs:
        try:
            cb()
        except Exception:
            pass            # a broken dump hook must not kill the watchdog


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v else default
    except ValueError:
        return default


def _rss_mb() -> float:
    """Resident set size in MiB (/proc on Linux, getrusage fallback)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    try:
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        if sys.platform == "darwin":        # ru_maxrss is bytes on macOS
            rss_kb /= 1024.0
        return round(rss_kb / 1024.0, 1)
    except Exception:
        return -1.0


def _all_thread_tracebacks() -> str:
    """faulthandler dump of every thread, as text (bounded)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()[-8000:]
    except Exception:
        import traceback
        frames = sys._current_frames()
        return "".join(
            f"Thread {tid}:\n" + "".join(traceback.format_stack(fr))
            for tid, fr in frames.items())[-8000:]


class Watchdog:
    """Daemon heartbeat/stall monitor bound to a :class:`Journal`.

    Progress = any non-heartbeat journal record, or an explicit
    ``beat()`` from code that is busy without journaling (a long compile
    loop). One traceback dump per stall episode; a new dump arms again
    once progress resumes.
    """

    def __init__(self, journal: Journal | None = None, interval_s=None,
                 stall_s=None):
        self.journal = journal or get_journal()
        self.interval_s = (float(interval_s) if interval_s is not None
                           else _env_float("MXNET_TPU_HEARTBEAT_S",
                                           DEFAULT_INTERVAL_S))
        self.stall_s = (float(stall_s) if stall_s is not None
                        else _env_float("MXNET_TPU_STALL_S",
                                        DEFAULT_STALL_S))
        self._stop = threading.Event()
        self._thread = None
        self._last_beat = time.monotonic()
        self._dumped = False
        self._t0 = time.monotonic()

    def beat(self) -> None:
        """Record progress without writing a journal record."""
        self._last_beat = time.monotonic()

    def _idle_s(self) -> float:
        last = max(self._last_beat, self.journal.last_activity)
        return time.monotonic() - last

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxnet-torch-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            idle = self._idle_s()
            self.journal.event("heartbeat", _heartbeat=True,
                               rss_mb=_rss_mb(),
                               wall_s=round(time.monotonic() - self._t0, 1),
                               idle_s=round(idle, 1))
            if idle > self.stall_s:
                if not self._dumped:
                    self._dumped = True
                    # _heartbeat=True: the stall record must not count as
                    # progress, or it would reset its own idle clock
                    self.journal.event(
                        "stall", _heartbeat=True, idle_s=round(idle, 1),
                        stall_threshold_s=self.stall_s,
                        rss_mb=_rss_mb(),
                        tracebacks=_all_thread_tracebacks())
                    # the wedge hook: a registered flight recorder dumps
                    # its span/journal rings while the process can still
                    # be read (the supervisor's kill comes later)
                    _fire_stall_callbacks()
            else:
                self._dumped = False     # progress resumed: re-arm

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
