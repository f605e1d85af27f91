"""Parallel and long-context attention (counterpart of
``mxnet_tpu/parallel/``). Only the single-device part of
``ring_attention`` is ported: the dense oracle and blockwise (flash)
attention."""
from __future__ import annotations

from . import ring_attention
from .ring_attention import attention_reference, blockwise_attention

__all__ = ["attention_reference", "blockwise_attention", "ring_attention"]
