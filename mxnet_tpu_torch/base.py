"""Base utilities for mxnet_tpu_torch (counterpart of ``mxnet_tpu/base.py``).

The port keeps the framework's one error type; dtype plumbing maps the
MXNet dtype names onto ``torch.dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "as_torch_dtype", "dtype_name", "jax_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: MXGetLastError carries C++ errors
    across the C ABI; here plain Python exceptions)."""


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64, "double": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint32": torch.uint32,
    "uint64": torch.uint64, "bool": torch.bool,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / numpy dtype / ``torch.dtype`` → ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES and not isinstance(dtype, str):
        try:                                 # np.float32, float, bool
            name = np.dtype(dtype).name
        except TypeError:
            pass
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}; one of "
                         f"{sorted(_DTYPES)}") from None


def jax_dtype(dtype) -> torch.dtype:
    """``dtype`` as the ``torch.dtype`` the JAX package would hold: with
    JAX's x64 off a 64-bit request comes back 32-bit (``mx.nd``'s
    creation functions, ``Cast``, the samplers' ``dtype``)."""
    d = as_torch_dtype(dtype)
    return {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.uint64: torch.uint32}.get(d, d)


def dtype_name(dtype) -> str:
    """The MXNet name of a ``torch.dtype`` (``torch.bfloat16`` →
    ``"bfloat16"``), as the JAX package's files spell dtypes."""
    return str(dtype).replace("torch.", "")
