"""Elastic training (counterpart of ``mxnet_tpu/elastic``): the
topology-free checkpoint reader (:mod:`.reshard`) that
``parallel.ShardedTrainer.load_checkpoint_resharded`` uses, and the
heartbeat liveness of :mod:`.membership` (``Heartbeat``,
``LivenessReader``) that the serving replica pool rides. The cohort
control plane, the collective and the resize loop are ROADMAP Queue 1
item 13."""
from __future__ import annotations

from . import membership, reshard
from .membership import Heartbeat, LivenessReader

__all__ = ["Heartbeat", "LivenessReader", "membership", "reshard"]
