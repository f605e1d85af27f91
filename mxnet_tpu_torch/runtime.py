"""``mx.runtime`` — what this build runs on (counterpart of
``mxnet_tpu/runtime.py``, ref ``python/mxnet/runtime.py`` Features /
feature_list over libinfo.cc): the card (``CUDA``, ``CUDNN``, ``BF16``),
the collectives (``NCCL``, ``DIST_KVSTORE``), the toolkit that builds
the port's kernels (``NVCC``) and, per kernel source, whether its library
is built for this checkout (``KERNEL_<NAME>``: compiled by nvcc at the
first launch or by ``kernels._build.build_all``)."""
from __future__ import annotations

import importlib.util
import os

import torch

from .base import MXNetError

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _nvcc():
    from .kernels import _build
    try:
        return os.path.exists(_build.nvcc_path())
    except MXNetError:        # no toolkit on this machine
        return False


def _detect():
    from .kernels import _build
    cuda = torch.cuda.is_available()
    feats = {
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "BF16": cuda and torch.cuda.is_bf16_supported(),
        "CPU": True,
        "F16C": True,
        "BLAS_OPEN": True,
        "NCCL": torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
        "DIST_KVSTORE": torch.distributed.is_available(),
        "NVCC": _nvcc(),
        "OPENCV": importlib.util.find_spec("cv2") is not None,
        "INT8_QUANTIZATION": False,
    }
    for name in _build.SOURCES:
        feats[f"KERNEL_{name.upper()}"] = _build._target(name).exists()
    return feats


class Features(dict):
    """ref: runtime.Features — a dict of :class:`Feature` with
    ``is_enabled``."""

    def __init__(self):
        super().__init__({name: Feature(name, on)
                          for name, on in _detect().items()})

    def is_enabled(self, name):
        name = name.upper()
        return name in self and self[name].enabled

    def __repr__(self):
        return "[" + ", ".join(repr(f) for f in self.values()) + "]"


def feature_list():
    return list(Features().values())
