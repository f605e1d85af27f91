"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from __future__ import annotations

from . import bert, vision

__all__ = ["bert", "vision"]
