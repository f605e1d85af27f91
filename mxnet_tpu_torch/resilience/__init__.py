"""Crash consistency and transient-fault handling (counterpart of
``mxnet_tpu/resilience``). Stdlib only at import:

- :mod:`.atomic` — ``atomic_write``: tmp, fsync, ``os.replace``, the one
  write path of durable files, with the fault-injection hook;
- :mod:`.commit` — the directory commit protocol of checkpoints: staged
  files, a CRC'd MANIFEST behind one rename, a ``latest`` pointer,
  keep-last-k GC and validated newest-first restore;
- :mod:`.retry` — bounded exponential backoff with jitter, journaled.

The reference's ``preempt`` (SIGTERM to a checkpoint at the next step)
is ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from . import atomic, commit, retry
from .atomic import atomic_write, fsync_dir, sweep_tmp
from .commit import find_restorable, validate_step
from .retry import backoff_delays, retry_call

__all__ = ["atomic", "atomic_write", "backoff_delays", "commit",
           "find_restorable", "fsync_dir", "retry", "retry_call",
           "sweep_tmp", "validate_step"]
