"""``mx.nd`` (counterpart of ``mxnet_tpu/ndarray``): for now the
``.params`` container only, :func:`save` and :func:`load` over
``torch.Tensor``s. NDArray and the operator namespace are ROADMAP Queue
1 item 6."""
from __future__ import annotations

from .ndarray import load, save

__all__ = ["load", "save"]
