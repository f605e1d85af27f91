"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from __future__ import annotations

from .optimizer import (DCASGD, FTML, FTRL, LAMB, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, AdamW, Nadam, Optimizer, RMSProp,
                        Signum, Updater, create, get_updater, register)

__all__ = ["AdaDelta", "AdaGrad", "Adam", "AdamW", "DCASGD", "FTML", "FTRL",
           "LAMB", "NAG", "Nadam", "Optimizer", "RMSProp", "SGD", "SGLD",
           "Signum", "Updater", "create", "get_updater", "register"]
