"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A Block is a ``torch.nn.Module`` whose ``forward(x)`` calls the port's
plain operator functions on tensors. Children and parameters keep the
JAX package's *structural* names (``features.4.0.body.1.gamma``, see
``Block._structural_names`` there), so ``state_dict()`` keys equal the
JAX checkpoint keys. A block's mode (``Block.training``) is that of the
innermost ``autograd`` scope: training inside ``autograd.record()`` or
``train_mode()``, predict inside ``record(train_mode=False)``, ``pause()``
or ``predict_mode()``. Outside every scope a block keeps its own mode:
predict, as Gluon runs outside ``autograd.record``, unless ``.train()``
switched it.

``HybridBlock.hybridize()`` is the reference's CachedOp: on the card a
hybridized block runs each call as CUDA graphs, one program per (mode,
recording, input shapes and dtypes, device), captured at the first call
of its key (:mod:`.cached_graph`); blocks nested in it run inside its
graphs. On the CPU, which a caller asks for explicitly, it runs eagerly.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy

from .. import autograd as _autograd
from .. import initializer as _init_mod
from .. import ndarray as nd
from ..base import MXNetError, as_torch_dtype
from ..context import resolve_device
from .cached_graph import (CudaGraphs, GraphCache, in_capture,
                           structure_changed)
from .parameter import DeferredParams

__all__ = ["Block", "HybridBlock", "ParameterDict"]


class ParameterDict(OrderedDict):
    """Structural name → parameter or buffer, as ``collect_params``
    returns it (ref: gluon.ParameterDict)."""

    def setattr(self, name, value):
        """Set attribute ``name`` of every tensor in the dict (ref:
        ParameterDict.setattr), e.g. ``net.collect_params(".*bias")
        .setattr("wd_mult", 0.0)``. ``gluon.Trainer`` hands the tensors
        to its optimizer as ``param_dict``, so ``lr_mult`` and
        ``wd_mult`` reach its update; ``parallel.ShardedTrainer`` does
        not read them, as in the reference: give its optimizer
        ``param_dict`` or ``set_wd_mult`` by trainable index there."""
        for t in self.values():
            setattr(t, name, value)


def _has_ndarray(values):
    for v in values:
        if isinstance(v, nd.NDArray) or (isinstance(v, (tuple, list))
                                         and _has_ndarray(v)):
            return True
    return False


def _unwrap(v):
    """NDArrays (also inside tuples and lists) as their tensors."""
    if isinstance(v, nd.NDArray):
        return v._data
    if isinstance(v, (tuple, list)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    """Tensors (also inside tuples and lists) as NDArrays."""
    if isinstance(v, torch.Tensor):
        return nd.NDArray(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_wrap(x) for x in v)
    return v


class Block(nn.Module):
    """Base class of all layers and models (ref: gluon/block.py Block).

    Called with NDArrays (``mx.nd``), a block unwraps them (also inside
    tuples and lists) to their tensors, runs with recording as
    ``autograd.is_recording()`` says, and wraps its tensor outputs as
    NDArrays; called with tensors it runs and returns tensors as ever.
    NDArrays that ``forward`` returns (an ``mx.nd`` sampler's) come back
    as tensors to a tensor caller and to a graph capture."""

    def __init__(self):
        super().__init__()
        self.training = False          # Gluon's default: predict mode

    def __call__(self, *args, **kwargs):
        if _has_ndarray(args) or _has_ndarray(kwargs.values()):
            args = _unwrap(args)
            kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
            with torch.set_grad_enabled(_autograd.is_recording()):
                return _wrap(self._call(*args, **kwargs))
        out = self._call(*args, **kwargs)
        return out if isinstance(out, torch.Tensor) else _unwrap(out)

    def _call(self, *args, **kwargs):
        return super().__call__(*args, **kwargs)

    @property
    def training(self):
        """Training mode: the innermost ``autograd`` scope's, else the
        block's own (``.train()`` / ``.eval()``)."""
        mode = _autograd.scope_training()
        return self.__dict__.get("_own_training", False) if mode is None \
            else mode

    @training.setter
    def training(self, value):
        self.__dict__["_own_training"] = bool(value)

    # a captured graph reads tensors by address: a program lists its
    # block's tensors anew after any of these
    def __setattr__(self, name, value):
        if isinstance(value, nn.Module):
            structure_changed()
        super().__setattr__(name, value)

    def add_module(self, name, module):
        structure_changed()
        super().add_module(name, module)

    def register_parameter(self, name, param):
        structure_changed()
        super().register_parameter(name, param)

    def register_buffer(self, name, tensor, persistent=True):
        structure_changed()
        super().register_buffer(name, tensor, persistent)

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
        self._clear_cached_op()
        return self

    def collect_params(self, select=None) -> ParameterDict:
        """Structural name → parameter or buffer of this block and its
        descendants (ref: Block.collect_params; keys as
        ``_structural_names``). ``select`` is a regex on the name."""
        pattern = None if select is None else re.compile(select)
        return ParameterDict(
            (k, v) for k, v in self.state_dict(keep_vars=True).items()
            if pattern is None or pattern.match(k))

    # -- checkpointing (ref: Block.save_parameters / load_parameters) --------
    def load_dict(self, arrays, ctx=None, allow_missing=False,
                  ignore_extra=False, source="<param dict>"):
        """Load ``{structural name: array}`` (tensors or numpy arrays);
        missing keys, extra keys and shape mismatches raise unless
        allowed. ``arg:``/``aux:`` prefixes (a trainer checkpoint's) are
        stripped, as in the reference. Uninitialized parameters
        materialize from the loaded shapes on the device ``initialize``
        chose, else on ``ctx`` (default ``cuda:0``)."""
        arrays = {k.partition(":")[2] if k.partition(":")[0] in
                  ("arg", "aux") and ":" in k else k: v
                  for k, v in arrays.items()}
        params = self.collect_params()
        missing = [k for k in params if k not in arrays]
        if missing and not allow_missing:
            raise MXNetError(f"parameters {missing} missing from {source}")
        extra = sorted(set(arrays) - set(params))
        if extra and not ignore_extra:
            raise MXNetError(f"{source} has extra parameters {extra}; pass "
                             "ignore_extra=True")
        device, rebound = None, False
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
                    rebound = True
        state = {k: v if isinstance(v, torch.Tensor)
                 else torch.tensor(np.asarray(v))
                 for k, v in arrays.items() if k in params}
        self.load_state_dict(state, strict=False)   # in place where live
        if rebound:
            self._clear_cached_op()
        return self

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter and buffer to ``filename`` as the
        ``.params`` container keyed by structural name (``nd.save``), the
        file the JAX package's ``save_parameters`` writes and its
        ``load_parameters`` reads."""
        nd.save(filename, dict(self.collect_params()))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a ``.params`` file of either package (``nd.load``) through
        :meth:`load_dict`."""
        loaded = nd._load_tensors(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} is not a parameter dict file")
        return self.load_dict(loaded, ctx=ctx, allow_missing=allow_missing,
                              ignore_extra=ignore_extra, source=filename)

    def cast(self, dtype):
        """Cast every floating parameter and buffer of this block and its
        descendants to ``dtype`` (ref: Block.cast), and reset each
        parameter's gradient to zeros of the new dtype, as the reference
        re-creates the gradient buffer. Parameters still to infer take
        ``dtype`` when they materialize. Drops the captured graphs."""
        dtype = as_torch_dtype(dtype)
        for module in self.modules():
            for spec in getattr(module, "_specs", {}).values():
                if spec.dtype.is_floating_point:
                    spec.dtype = dtype
        with torch.no_grad():
            for t in self.state_dict(keep_vars=True).values():
                if t.is_floating_point():
                    t.data = t.data.to(dtype)
                    if t.grad is not None:
                        t.grad = torch.zeros_like(t)
        self._clear_cached_op()
        return self

    def hybridize(self, active=True, **kwargs):
        """Nothing on a plain Block; recurses so that nested HybridBlocks
        engage (ref: Block.hybridize)."""
        for child in self.children():
            child.hybridize(active, **kwargs)

    def _clear_cached_op(self):
        """Drop the captured graphs of this block and its descendants
        (ref: HybridBlock._clear_cached_op): after ``initialize`` and
        after a load that rebound a deferred parameter's storage."""
        for module in self.modules():
            graphs = module.__dict__.get("_graphs")
            if graphs is not None:
                graphs.clear()


class HybridBlock(Block):
    """A Block that runs as one compiled program per input signature once
    hybridized (ref: gluon/block.py HybridBlock; CachedOp ≡ CUDA graphs
    here, see :mod:`.cached_graph`)."""

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None):
        """Capture this block's calls on the card as CUDA graphs
        (``active``), or stop (``active=False``). Every call drops the
        graphs captured so far and frees their pools, then recurses into
        the children. The other arguments are the reference's and change
        nothing: a graph is always statically allocated."""
        self._clear_cached_op()
        self.__dict__["_graphs"] = GraphCache(CudaGraphs()) if active \
            else None
        for child in self.children():
            child.hybridize(active, static_alloc=static_alloc,
                            static_shape=static_shape)

    def _call(self, *args, **kwargs):
        """ref: HybridBlock.__call__ — the cached program when hybridized
        and no outer program is being captured on this thread, else the
        eager forward."""
        graphs = self.__dict__.get("_graphs")
        if graphs is None or in_capture():
            return nn.Module.__call__(self, *args, **kwargs)
        return graphs.call(self, args, kwargs)
