"""Runtime diagnostics (counterpart of ``mxnet_tpu/diagnostics``): the
structured event journal (:mod:`.journal`). The backend guard, the
watchdog, the signal and exit handlers and the ``doctor`` command are
ROADMAP Queue 1 item 13.

Import-light: importing this package touches nothing else of the port.
"""
from __future__ import annotations

from .journal import Journal, get_journal, reset_journal

__all__ = ["Journal", "get_journal", "reset_journal"]
