"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib``)."""
from __future__ import annotations

from . import estimator, nn
from .nn import Concurrent, HybridConcurrent, Identity

__all__ = ["nn", "estimator", "Concurrent", "HybridConcurrent", "Identity"]
