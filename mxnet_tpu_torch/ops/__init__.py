"""Operators of the port (counterpart of ``mxnet_tpu/ops/``): plain
functions on tensors, named after the JAX package's registered ops."""
from __future__ import annotations

from . import contrib, namespace, nn, optimizer_op, tensor

__all__ = ["contrib", "namespace", "nn", "optimizer_op", "tensor"]
