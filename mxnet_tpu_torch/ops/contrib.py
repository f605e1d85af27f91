"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``)."""
from __future__ import annotations

from ..kernels import fused_conv_epilogue

__all__ = ["conv_epilogue"]


def conv_epilogue(x, res, act_type="relu"):
    """ref: ``_contrib_conv_epilogue`` — the residual epilogue
    ``act(x + res)`` in one pass: the conv-epilogue kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return fused_conv_epilogue(x, res=res, act_type=act_type)
