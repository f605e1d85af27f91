"""Training guardrails (counterpart of ``mxnet_tpu/guardrails``): the
fused in-step guard math (:mod:`.fused`). The divergence monitor and
rollback (``GuardConfig``, ``AnomalyMonitor``) are not ported yet."""
from __future__ import annotations

from . import fused

__all__ = ["fused"]
