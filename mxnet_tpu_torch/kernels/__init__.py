"""Hand-written CUDA kernels of the port (counterpart of
``mxnet_tpu/pallas/``).

Each kernel module holds the kernel's wrapper, its plain PyTorch version
and a launch count; ``csrc/`` holds the CUDA sources, which
:mod:`._build` compiles for Hopper at first use. A CPU tensor takes the
plain version; a CUDA tensor takes the kernel or the call raises.
"""
from __future__ import annotations

from . import conv_epilogue
from .conv_epilogue import (EPILOGUE_ACTS, conv_epilogue_plain,
                            fused_conv_epilogue)

__all__ = ["EPILOGUE_ACTS", "conv_epilogue_plain", "fused_conv_epilogue",
           "launch_counts", "reset_launch_counts"]

_COUNTS = {"conv_epilogue": conv_epilogue.launch_count}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: c.value for name, c in _COUNTS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTS.values():
        c.reset()
