"""mxnet_tpu_torch — the PyTorch and CUDA port of ``mxnet_tpu``.

The MXNet 1.x surface of the JAX package, re-built on PyTorch for NVIDIA
Hopper cards: Gluon blocks are ``torch.nn.Module`` objects, operators are
plain functions on tensors, and every kernel the JAX package wrote in
Pallas for the TPU is a kernel written by hand in CUDA C++ (``kernels/``).
Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``ctx=mx.cpu()``); without a card they raise rather than carry on.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``mxnet_tpu``.
"""
from __future__ import annotations

from . import (convert, gluon, initializer, kernels, ops, random,
               serving)
from .base import MXNetError
from .context import Context, cpu, current_context, gpu

init = initializer

__all__ = ["Context", "MXNetError", "convert", "cpu", "current_context",
           "gluon", "gpu", "init", "initializer", "kernels", "ops",
           "random", "serving"]
__version__ = "0.1.0"
