"""gluon.contrib.nn (counterpart of ``mxnet_tpu/gluon/contrib/nn``)."""
from __future__ import annotations

from ....base import MXNetError
from ....ops import tensor as _tensor
from ...block import HybridBlock
from ...nn import HybridSequential, Sequential, SyncBatchNorm

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "MoEFFN",
           "SyncBatchNorm"]


class HybridConcurrent(HybridSequential):
    """Children run on the same input, their outputs concatenated along
    ``axis`` (ref: contrib.nn HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _tensor.concat(*[block(x) for block in self],
                              dim=self.axis)


class Concurrent(Sequential):
    """The Block form of :class:`HybridConcurrent` (ref: contrib.nn
    Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _tensor.concat(*[block(x) for block in self],
                              dim=self.axis)


class Identity(HybridBlock):
    """ref: contrib.nn Identity."""

    def forward(self, x):
        return x


class MoEFFN(HybridBlock):
    """The JAX package's top-k mixture-of-experts FFN. It routes tokens
    over an ``expert`` mesh axis, and the port's meshes have one device
    until ROADMAP Queue 1 item 9; constructing it raises."""

    def __init__(self, units, hidden_size, num_experts, k=2,
                 capacity_factor=1.5, activation="gelu",
                 aux_loss_weight=0.01, expert_axis="expert", **kwargs):
        raise MXNetError("MoEFFN is not ported yet: it needs the expert-"
                         "parallel meshes of ROADMAP Queue 1 item 9")
