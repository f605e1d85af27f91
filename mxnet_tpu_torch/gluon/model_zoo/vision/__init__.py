"""Vision models (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``)."""
from __future__ import annotations

from .resnet import *   # noqa: F401,F403
from .resnet import __all__   # noqa: F401
