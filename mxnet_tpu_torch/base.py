"""Base utilities for mxnet_tpu_torch (counterpart of ``mxnet_tpu/base.py``).

The port keeps the framework's one error type; dtype plumbing maps the
MXNet dtype names onto ``torch.dtype``.
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "as_torch_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: MXGetLastError carries C++ errors
    across the C ABI; here plain Python exceptions)."""


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "float16": torch.float16, "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64, "double": torch.float64,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / numpy dtype / ``torch.dtype`` → ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    try:
        return _DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}; one of "
                         f"{sorted(_DTYPES)}") from None
