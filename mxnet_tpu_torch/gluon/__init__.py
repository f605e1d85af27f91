"""Gluon for the port (counterpart of ``mxnet_tpu/gluon``)."""
from __future__ import annotations

from . import loss, model_zoo, nn, utils
from . import contrib           # after nn and utils, which it imports
from .block import Block, HybridBlock, ParameterDict, SymbolBlock
from .parameter import DeferredInitializationError
from .trainer import Trainer

__all__ = ["Block", "DeferredInitializationError", "HybridBlock",
           "ParameterDict", "SymbolBlock", "Trainer", "contrib", "loss",
           "model_zoo", "nn", "utils"]
