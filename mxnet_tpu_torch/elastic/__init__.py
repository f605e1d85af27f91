"""Elastic training (counterpart of ``mxnet_tpu/elastic``): for now the
topology-free checkpoint reader (:mod:`.reshard`) that
``parallel.ShardedTrainer.load_checkpoint_resharded`` uses. Membership,
the cohort collective and the resize loop are ROADMAP Queue 1 item
13."""
from __future__ import annotations

from . import reshard

__all__ = ["reshard"]
