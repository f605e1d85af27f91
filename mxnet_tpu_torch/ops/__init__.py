"""Operators of the port (counterpart of ``mxnet_tpu/ops/``): plain
functions on tensors, named after the JAX package's registered ops."""
from __future__ import annotations

from . import contrib, nn, tensor

__all__ = ["contrib", "nn", "tensor"]
