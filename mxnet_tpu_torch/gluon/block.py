"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A Block is a ``torch.nn.Module`` whose ``forward(x)`` calls the port's
plain operator functions on tensors. Children and parameters keep the
JAX package's *structural* names (``features.4.0.body.1.gamma``, see
``Block._structural_names`` there), so ``state_dict()`` keys equal the
JAX checkpoint keys. Blocks start in predict mode, as Gluon runs outside
``autograd.record(train_mode=True)``; ``.train()`` switches a block to
training mode.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy

from .. import initializer as _init_mod
from ..base import MXNetError
from ..context import resolve_device
from .parameter import DeferredParams

__all__ = ["Block", "HybridBlock"]


class Block(nn.Module):
    """Base class of all layers and models (ref: gluon/block.py Block)."""

    def __init__(self):
        super().__init__()
        self.training = False          # Gluon's default: predict mode

    def initialize(self, init=None, ctx=None, generator=None,
                   force_reinit=False):
        """Materialize and fill every parameter whose shape is known on
        ``ctx`` (default ``cuda:0``; raises without CUDA unless
        ``ctx=cpu()``), drawing from ``generator`` (PyTorch's default
        generator when None). Parameters with a shape still to infer
        materialize at the first forward with the same plan. ``init``
        defaults to ``Uniform(0.07)`` as in the reference; a layer's own
        initializer (e.g. BatchNorm gamma "ones") takes precedence."""
        device = resolve_device(ctx)
        init = _init_mod.create(init if init is not None
                                else _init_mod.Uniform())
        for module in self.modules():
            if isinstance(module, DeferredParams):
                module._init_params(init, device, generator, force_reinit)
        return self

    def collect_params(self, select=None) -> "OrderedDict[str, torch.Tensor]":
        """Structural name → parameter or buffer of this block and its
        descendants (ref: Block.collect_params; keys as
        ``_structural_names``). ``select`` is a regex on the name."""
        pattern = None if select is None else re.compile(select)
        return OrderedDict(
            (k, v) for k, v in self.state_dict(keep_vars=True).items()
            if pattern is None or pattern.match(k))

    # -- checkpointing over numpy dicts --------------------------------------
    def load_dict(self, arrays, ctx=None, allow_missing=False,
                  ignore_extra=False, source="<param dict>"):
        """Load ``{structural name: array}``; missing keys, extra keys and
        shape mismatches raise unless allowed. Uninitialized parameters
        materialize from the loaded shapes on the device ``initialize``
        chose, else on ``ctx`` (default ``cuda:0``)."""
        params = self.collect_params()
        missing = [k for k in params if k not in arrays]
        if missing and not allow_missing:
            raise MXNetError(f"parameters {missing} missing from {source}")
        extra = sorted(set(arrays) - set(params))
        if extra and not ignore_extra:
            raise MXNetError(f"{source} has extra parameters {extra}; pass "
                             "ignore_extra=True")
        device = None
        for key, cur in params.items():
            if key not in arrays:
                continue
            shape = tuple(np.shape(arrays[key]))
            if not is_lazy(cur) and tuple(cur.shape) != shape:
                raise MXNetError(f"parameter {key} is {shape} in {source}, "
                                 f"{tuple(cur.shape)} in the block")
        for module in self.modules():
            if not isinstance(module, DeferredParams) \
                    or module._init_plan is not None:
                continue                 # initialize() chose the device
            for name, spec in module._specs.items():
                if is_lazy(module._tensor(name)):
                    if device is None:
                        device = resolve_device(ctx)
                    module._reset_lazy(name, spec, device)
        state = {k: torch.tensor(np.asarray(v)) for k, v in arrays.items()
                 if k in params}
        self.load_state_dict(state, strict=False)
        return self

    def save_parameters(self, filename):
        """Write every parameter and buffer to ``filename`` as a numpy
        ``.npz`` keyed by structural name (not the MXNet ``.params``
        container)."""
        np.savez(filename, **{k: v.detach().cpu().numpy()
                              for k, v in self.collect_params().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        with np.load(filename) as data:
            arrays = {k: data[k] for k in data.files}
        return self.load_dict(arrays, ctx=ctx, allow_missing=allow_missing,
                              ignore_extra=ignore_extra, source=filename)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API compatibility and does nothing yet: the port
        runs eagerly. Capturing the forward as CUDA graphs is planned."""
        return None


class HybridBlock(Block):
    """A Block that the reference can compile as one graph (ref:
    gluon/block.py HybridBlock). In the port it is a plain Block:
    :meth:`Block.hybridize` is a no-op."""
