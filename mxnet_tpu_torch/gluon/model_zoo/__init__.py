"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from __future__ import annotations

from . import vision

__all__ = ["vision"]
