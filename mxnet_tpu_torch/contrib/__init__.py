"""Contrib packages of the port (counterpart of ``mxnet_tpu/contrib``):
``amp`` only."""
from __future__ import annotations

from . import amp

__all__ = ["amp"]
