"""Hand-written CUDA kernels of the port (counterpart of
``mxnet_tpu/pallas/``).

Each kernel module holds the kernel's wrapper, its plain PyTorch version
and a launch count; ``csrc/`` holds the CUDA sources, which
:mod:`._build` compiles for Hopper at first use. A CPU tensor takes the
plain version; a CUDA tensor takes the kernel or the call raises.

- K1 :mod:`.conv_epilogue`: ``act(scale * y + bias [+ res])``; its
  backward is the VJP of the plain version (no kernel of its own).
- K2 :mod:`.matmul_epilogue`: ``dropout(act(y + bias))``.
- K3/K3' :mod:`.flash_attention`: ``softmax(scale * q k^T) v`` streamed
  over key tiles (online softmax, bottom-right causal), and its backward
  as two kernels, dK/dV and dQ.
"""
from __future__ import annotations

from . import conv_epilogue, flash_attention, matmul_epilogue
from ._common import EPILOGUE_ACTS
from .conv_epilogue import conv_epilogue_plain, fused_conv_epilogue
from .flash_attention import flash_attention_bwd_plain, flash_attention_plain
from .matmul_epilogue import (fused_matmul_epilogue, keep_threshold,
                              matmul_epilogue_plain)

__all__ = ["EPILOGUE_ACTS", "add_launches", "captured_counts",
           "conv_epilogue_plain",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "fused_conv_epilogue", "fused_matmul_epilogue", "keep_threshold",
           "launch_counts", "matmul_epilogue_plain", "reset_launch_counts"]

_COUNTS = {"conv_epilogue": conv_epilogue.launch_count,
           "matmul_epilogue": matmul_epilogue.launch_count,
           "flash_attention": flash_attention.launch_count,
           "flash_attention_bwd_dkv": flash_attention.bwd_dkv_launch_count,
           "flash_attention_bwd_dq": flash_attention.bwd_dq_launch_count}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: c.value for name, c in _COUNTS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTS.values():
        c.reset()


def captured_counts() -> dict:
    """{kernel name: launches made into CUDA graph captures} (never
    reset): a capture's launches are its delta."""
    return {name: c.captured for name, c in _COUNTS.items()}


def add_launches(counts: dict) -> None:
    """Add {kernel name: launches} to the counts: what a CUDA graph's
    replay ran without calling the wrappers."""
    for name, n in counts.items():
        if n:
            _COUNTS[name].add_replayed(n)
