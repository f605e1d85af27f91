"""Bounded retry with exponential backoff and jitter for transient faults
(counterpart of ``mxnet_tpu/resilience/retry.py``).

Checkpoint filesystem operations over network mounts return spurious
EIO/ESTALE under load (``resilience.atomic``'s fsync and replace); a
short retry recovers far more often than such a fault merits ending a
training run.

Contract:

- The delay before retry ``i`` (0-based) is in ``[b_i, b_i*(1+jitter)]``
  where ``b_i = min(base_s * 2**i, max_s)``, so a caller can budget the
  worst-case stall.
- Every failed attempt is journaled (``kind: "retry"``).
- Only exceptions in ``retry_on`` are retried; everything else,
  including ``BaseException`` crash stand-ins of the fault-injection
  hook, propagates at once.
- Exhaustion is not transient: ENOSPC/EDQUOT fail on the first attempt
  (freeing space is the remedy), with one deduplicated ``disk_full``
  journal record per path.

Stdlib only.
"""
from __future__ import annotations

import errno
import os
import random
import threading
import time

from ..diagnostics.journal import get_journal

__all__ = ["backoff_delays", "is_disk_full", "note_disk_full",
           "reset_disk_full_notes", "retry_call"]

# exhaustion errnos no retry budget can fix
_FAIL_FAST_ERRNOS = frozenset(
    e for e in (errno.ENOSPC, getattr(errno, "EDQUOT", None))
    if e is not None)

# paths whose disk_full record was written: a full disk makes every
# writer fail, and one record per path tells the story
_noted_lock = threading.Lock()
_noted_paths: set = set()


def is_disk_full(exc) -> bool:
    """True for the exhaustion errnos (ENOSPC/EDQUOT) that fail fast
    instead of being retried."""
    return isinstance(exc, OSError) and exc.errno in _FAIL_FAST_ERRNOS


def note_disk_full(path, op: str) -> bool:
    """Journal one ``disk_full`` record for ``path`` (repeats on the same
    path are dropped). Returns whether a record was written."""
    key = str(path)
    with _noted_lock:
        if key in _noted_paths:
            return False
        _noted_paths.add(key)
    get_journal().event("disk_full", path=key, op=str(op))
    return True


def reset_disk_full_notes() -> None:
    """Forget which paths were noted, so the next exhaustion on any of
    them is journaled again."""
    with _noted_lock:
        _noted_paths.clear()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def backoff_delays(retries: int, base_s: float = 0.05, max_s: float = 2.0,
                   jitter: float = 0.5, rng=None) -> list[float]:
    """The sleep schedule of ``retries`` retry attempts: delay ``i``
    uniform in ``[b_i, b_i*(1+jitter)]``, ``b_i = min(base_s * 2**i,
    max_s)``."""
    draw = rng.random if rng is not None else random.random
    out = []
    for i in range(max(0, int(retries))):
        b = min(base_s * (2.0 ** i), max_s)
        out.append(b * (1.0 + jitter * draw()) if jitter > 0 else b)
    return out


def retry_call(fn, *args, retries: int | None = None,
               base_s: float | None = None, max_s: float = 2.0,
               jitter: float = 0.5, retry_on=(OSError,), what: str = "",
               rng=None, sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying transient failures.

    ``retries`` and ``base_s`` default from ``MXNET_TPU_RETRIES`` (2) and
    ``MXNET_TPU_RETRY_BASE_S`` (0.05 s). The last failure re-raises;
    the ones before it are journaled."""
    if retries is None:
        retries = _env_int("MXNET_TPU_RETRIES", 2)
    if base_s is None:
        base_s = _env_float("MXNET_TPU_RETRY_BASE_S", 0.05)
    delays = backoff_delays(retries, base_s, max_s, jitter, rng)
    what = what or getattr(fn, "__name__", "call")
    for attempt, delay in enumerate([*delays, None]):
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if is_disk_full(exc):
                note_disk_full(getattr(exc, "filename", None) or what,
                               op=what)
                raise
            if delay is None:
                raise
            get_journal().event(
                "retry", what=what, attempt=attempt + 1,
                retries=retries, delay_s=round(delay, 4),
                error=type(exc).__name__, detail=str(exc)[:200])
            sleep(delay)
