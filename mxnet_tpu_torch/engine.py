"""Execution-engine facade (counterpart of ``mxnet_tpu/engine.py``, ref
``include/mxnet/engine.h``).

MXNet's ThreadedEngine schedules ops asynchronously; CUDA streams do that
here, so this module keeps the reference's observable behaviour only:

- ops return to Python before the card finishes them (native to CUDA);
- :func:`waitall` and ``NDArray.wait_to_read`` are the barriers;
- ``MXNET_ENGINE_TYPE=NaiveEngine`` (or :func:`set_engine_type`) makes
  every ``mx.nd`` op wait for its outputs (ref:
  ``src/engine/naive_engine.cc``), so a failure surfaces at its op.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["bulk", "is_naive", "on_op_done", "set_engine_type", "waitall"]

_ENGINE_TYPE = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")


def set_engine_type(name: str):
    """Switch the engine mode at runtime ('NaiveEngine' is synchronous)."""
    global _ENGINE_TYPE
    _ENGINE_TYPE = name


def is_naive() -> bool:
    return _ENGINE_TYPE == "NaiveEngine"


def on_op_done(outputs):
    """Called by the dispatch after every op: under the NaiveEngine it
    waits for the card, so failures come in order."""
    if is_naive():
        for t in outputs:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
    return outputs


def waitall():
    """Barrier on every CUDA device the process has touched (ref:
    Engine::WaitForAll / ``mx.nd.waitall``); nothing to wait for on the
    CPU."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def bulk(size: int = 15):
    """ref: ``mx.engine.bulk``, which batches engine ops to cut dispatch
    cost. A scope that changes nothing, as in the JAX package (CUDA
    graphs batch launches here, ``hybridize()``); kept for scripts."""
    yield
