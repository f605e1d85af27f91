"""mxnet_tpu_torch — the PyTorch and CUDA port of ``mxnet_tpu``.

The MXNet 1.x surface of the JAX package, re-built on PyTorch for NVIDIA
Hopper cards: Gluon blocks are ``torch.nn.Module`` objects, operators are
plain functions on tensors registered under their MXNet names (``mx.nd``
wraps them for NDArrays and tensors), and every kernel the JAX package wrote in
Pallas for the TPU is a kernel written by hand in CUDA C++ (``kernels/``).
Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``ctx=mx.cpu()``); without a card they raise rather than carry on.

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``mxnet_tpu``.
"""
from __future__ import annotations

from . import (autograd, contrib, convert, diagnostics, engine, gluon,
               guardrails, initializer, kernels, lr_scheduler, metric,
               metric_det, ndarray, observability, ops, optimizer, parallel,
               random, resilience, serving)
from . import callback
from . import elastic           # after parallel, whose files it reads
from . import operator          # registers Custom
from . import (attribute, library, name, numpy_extension, runtime,
               test_utils, util)
from . import io, model, module, symbol, visualization
from . import numpy as np
from .attribute import AttrScope
from .base import MXNetError
from .context import Context, cpu, current_context, gpu

init = initializer
mod = module
nd = ndarray
npx = numpy_extension
sym = symbol
viz = visualization
# detection mAP lives beside the classification metrics, one registry
metric.VOCMApMetric = metric_det.VOCMApMetric
metric.VOC07MApMetric = metric_det.VOC07MApMetric

__all__ = ["AttrScope", "Context", "MXNetError", "attribute", "autograd",
           "callback", "contrib", "convert", "cpu", "current_context",
           "diagnostics", "elastic", "engine", "gluon", "gpu", "guardrails",
           "init", "initializer", "io", "kernels", "library",
           "lr_scheduler", "metric", "metric_det", "mod", "model", "module",
           "name", "nd", "ndarray", "np", "npx", "numpy_extension",
           "observability", "operator", "ops", "optimizer", "parallel",
           "random", "resilience", "runtime", "serving", "sym", "symbol",
           "test_utils", "util", "visualization", "viz"]
__version__ = "0.1.0"
