"""Runtime diagnostics (counterpart of ``mxnet_tpu/diagnostics``): the
structured event journal (:mod:`.journal`, with its SIGTERM/atexit
finalizers) and the heartbeat/stall watchdog (:mod:`.watchdog`). The
backend guard and the ``doctor`` command are ROADMAP Queue 1 item 13.

Import-light: importing this package touches nothing else of the port.
"""
from __future__ import annotations

from .journal import Journal, get_journal, reset_journal
from .watchdog import Watchdog

__all__ = ["Journal", "Watchdog", "get_journal", "reset_journal"]
