"""Gluon for the port (counterpart of ``mxnet_tpu/gluon``)."""
from __future__ import annotations

from . import model_zoo, nn
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError

__all__ = ["Block", "DeferredInitializationError", "HybridBlock",
           "model_zoo", "nn"]
