"""Gluon for the port (counterpart of ``mxnet_tpu/gluon``)."""
from __future__ import annotations

from . import loss, model_zoo, nn
from .block import Block, HybridBlock, ParameterDict
from .parameter import DeferredInitializationError
from .trainer import Trainer

__all__ = ["Block", "DeferredInitializationError", "HybridBlock",
           "ParameterDict", "Trainer", "loss", "model_zoo", "nn"]
