"""Crash consistency and transient-fault handling (counterpart of
``mxnet_tpu/resilience``). Stdlib only at import:

- :mod:`.atomic` — ``atomic_write``: tmp, fsync, ``os.replace``, the one
  write path of durable files, with the fault-injection hook;
- :mod:`.commit` — the directory commit protocol of checkpoints: staged
  files, a CRC'd MANIFEST behind one rename, a ``latest`` pointer,
  keep-last-k GC and validated newest-first restore;
- :mod:`.retry` — bounded exponential backoff with jitter, journaled;
- :mod:`.preempt` — SIGTERM latched into a checkpoint at the next step
  boundary (``Module.fit(checkpoint_prefix=)`` installs it).
"""
from __future__ import annotations

from . import atomic, commit, preempt, retry
from .atomic import atomic_write, fsync_dir, sweep_tmp
from .commit import find_restorable, validate_step
from .retry import backoff_delays, retry_call

__all__ = ["atomic", "atomic_write", "backoff_delays", "commit",
           "find_restorable", "fsync_dir", "preempt", "retry", "retry_call",
           "sweep_tmp", "validate_step"]
