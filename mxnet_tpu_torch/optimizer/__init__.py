"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from __future__ import annotations

from .optimizer import (SGD, Adam, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["Adam", "Optimizer", "SGD", "Updater", "create", "get_updater",
           "register"]
