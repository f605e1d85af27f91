"""Tensor operators (counterpart of ``mxnet_tpu/ops/tensor.py``)."""
from __future__ import annotations

__all__ = ["flatten"]


def flatten(x):
    """ref: Flatten — (N, d1, d2, ...) → (N, d1*d2*...)."""
    return x.reshape(x.shape[0], -1)
