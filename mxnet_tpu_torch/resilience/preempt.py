"""SIGTERM-aware preemption handling (counterpart of
``mxnet_tpu/resilience/preempt.py``): checkpoint at the next step
boundary instead of dying mid-write.

Preemptible machines deliver SIGTERM with a grace window. The default
disposition (or the diagnostics journal's breadcrumb handler) turns
that into process death; this module turns it into a *request*: the
watch latches the signal, the training loop polls it at step
boundaries, saves one checkpoint through the atomic/commit paths, and
exits cleanly. ``BaseModule.fit(checkpoint_prefix=...)`` wires this in
automatically; :func:`checkpoint_on_preempt` is the standalone hook for
hand-rolled loops.

The watch installs itself as the OUTERMOST SIGTERM handler (re-invoke
:func:`install` to re-assert that after other subsystems register
theirs) and deliberately does not chain: graceful save supersedes
immediate death. The journal's ``atexit`` finalizer still writes its
exit breadcrumb on the way out.
"""
from __future__ import annotations

import signal
import threading

from ..diagnostics.journal import get_journal

__all__ = ["PreemptionWatch", "checkpoint_on_preempt", "install",
           "requested"]


class PreemptionWatch:
    """Latches SIGTERM; ``consume()`` hands exactly one caller the duty
    of saving (so a fit loop and a user callback can both poll)."""

    def __init__(self):
        self._flag = threading.Event()
        self._lock = threading.Lock()
        self._consumed = False
        self._installed = False
        self._prev = None
        # ONE bound-method instance: `self._on_term` evaluates to a
        # fresh object per access, so identity checks against what
        # signal.signal stored would never match without this pin
        self._handler = self._on_term

    def _on_term(self, signum, frame):
        self._flag.set()
        get_journal().event("preempt_requested", signum=signum)

    def install(self) -> "PreemptionWatch":
        """(Re-)bind SIGTERM to the watch, remembering the displaced
        disposition for :meth:`uninstall`. Safe to call repeatedly;
        only binds in the main thread (signal module constraint)."""
        try:
            prev = signal.getsignal(signal.SIGTERM)
            if prev is not self._handler:
                self._prev = prev
                signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        except ValueError:
            pass             # non-main thread: poll-only watch
        return self

    def uninstall(self) -> None:
        """Restore the displaced SIGTERM disposition. Called when the
        polling loop ends (fit returns): a latched-but-never-polled
        watch would make the process silently ignore SIGTERM — worse
        than the default death it replaced."""
        try:
            if self._installed and \
                    signal.getsignal(signal.SIGTERM) is self._handler:
                signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False
        except ValueError:
            pass

    def requested(self) -> bool:
        return self._flag.is_set()

    def consume(self) -> bool:
        """True exactly once after a SIGTERM: the caller that wins
        saves the checkpoint; everyone else stands down."""
        if not self._flag.is_set():
            return False
        with self._lock:
            if self._consumed:
                return False
            self._consumed = True
            return True

    def clear(self) -> None:
        """Full reset (tests / drivers that survived a drill)."""
        self._flag.clear()
        with self._lock:
            self._consumed = False

    def rearm(self) -> None:
        """Reset only a CONSUMED watch (a new training run starting in
        the same process). A live, unconsumed SIGTERM — a preemption
        that raced startup — stays latched and still triggers the
        boundary save."""
        with self._lock:
            if self._consumed:
                self._consumed = False
                self._flag.clear()


_watch: PreemptionWatch | None = None
_watch_lock = threading.Lock()


def install() -> PreemptionWatch:
    """The process-wide watch, SIGTERM bound (idempotent; re-asserts
    the binding if something else grabbed the signal since)."""
    global _watch
    with _watch_lock:
        if _watch is None:
            _watch = PreemptionWatch()
    return _watch.install()


def requested() -> bool:
    return _watch is not None and _watch.requested()


def checkpoint_on_preempt(module, prefix: str, keep_last: int | None = None):
    """Batch-end callback for hand-rolled loops: after a SIGTERM, save
    ``module``'s checkpoint at the current step boundary (journaled as
    ``preempt_checkpoint``) — once per installation (creating the
    callback re-arms a watch an earlier training run consumed; a live
    unconsumed signal stays latched)."""
    watch = install()
    watch.rearm()

    def _callback(param):
        if not watch.consume():
            return
        module.save_checkpoint(prefix, param.epoch)
        if keep_last:
            from .. import model
            model.gc_checkpoints(prefix, keep_last)
        get_journal().event("preempt_checkpoint", prefix=prefix,
                            epoch=param.epoch, nbatch=param.nbatch)
    return _callback
