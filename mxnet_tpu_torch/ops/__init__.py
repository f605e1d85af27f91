"""Operators of the port (counterpart of ``mxnet_tpu/ops/``): plain
functions on tensors, registered under the JAX package's operator names
in the typed registry (:mod:`.registry`), from which ``mx.nd`` generates
its namespace. Importing a module registers its operators."""
from __future__ import annotations

from . import registry
from . import tensor, elemwise, nn, random, optimizer_op, contrib, sequence
from .registry import OpParam, Operator, get, list_ops, register

__all__ = ["OpParam", "Operator", "contrib", "elemwise", "get", "list_ops",
           "nn", "optimizer_op", "random", "register", "registry",
           "sequence", "tensor"]
