"""Training anomaly guardrails (counterpart of ``mxnet_tpu/guardrails``):
the fused in-step guard math (:mod:`.fused`), the host-side divergence
monitor and its policy (:mod:`.monitor`: ``GuardConfig``,
``AnomalyMonitor``, ``TrainingDiverged``), the trainers' shared
bookkeeping (:mod:`.trainer_mixin`) and the journal summary
(:mod:`.report`). With ``GuardConfig(ckpt_root=)`` a divergence rolls
back to the newest valid committed checkpoint."""
from __future__ import annotations

from . import fused
from .monitor import (AnomalyMonitor, GuardConfig, TrainingDiverged,
                      handle_divergence)
from .report import guard_report

__all__ = ["AnomalyMonitor", "GuardConfig", "TrainingDiverged", "fused",
           "guard_report", "handle_divergence"]
