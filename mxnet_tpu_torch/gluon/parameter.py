"""Gluon parameters (counterpart of ``mxnet_tpu/gluon/parameter.py``).

The port keeps Gluon's two-step life of a parameter — declared with a
shape in which ``0`` means "infer from the first input", filled by
``initialize()`` — on top of PyTorch's lazy modules: every parameter
starts as a ``torch.nn.UninitializedParameter`` (running statistics as
``UninitializedBuffer``), ``Block.initialize`` materializes the ones
whose shape is known, and the rest materialize at the first forward
through ``LazyModuleMixin.initialize_parameters``, on the device and
with the initializer that ``initialize`` recorded. Loading a state dict
into an uninitialized layer materializes it from the loaded shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import (UninitializedBuffer, UninitializedParameter,
                                is_lazy)

from .. import initializer as _init_mod
from ..base import MXNetError, as_torch_dtype

__all__ = ["DeferredInitializationError", "DeferredParams", "ParamSpec"]


class DeferredInitializationError(MXNetError):
    """A forward reached parameters that were neither initialized
    (``initialize()``) nor loaded."""


@dataclass
class ParamSpec:
    """What a layer declared for one parameter: ``shape`` (0 = inferred
    from the input), its own initializer (None = the global one passed to
    ``initialize``), dtype, and whether it is auxiliary state (a buffer,
    like BatchNorm's running statistics)."""

    shape: tuple
    init: object = None
    dtype: torch.dtype = torch.float32
    aux: bool = False
    differentiable: bool = True

    @property
    def complete(self) -> bool:
        return all(int(s) > 0 for s in self.shape)


class DeferredParams(LazyModuleMixin):
    """Mixin for layers that own parameters (put it before the Block
    class in the bases). Layers declare parameters with
    :meth:`_declare` and implement :meth:`infer_shape`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._specs = {}
        self._init_plan = None       # (initializer, generator, device)

    def _declare(self, name, shape, init=None, dtype="float32", aux=False,
                 differentiable=True):
        spec = ParamSpec(tuple(int(s) for s in shape), init,
                         as_torch_dtype(dtype), aux, differentiable)
        self._specs[name] = spec
        self._reset_lazy(name, spec, None)

    def _reset_lazy(self, name, spec, device):
        if spec.aux:
            self._buffers[name] = UninitializedBuffer(device=device,
                                                      dtype=spec.dtype)
        else:
            self._parameters[name] = UninitializedParameter(
                requires_grad=spec.differentiable, device=device,
                dtype=spec.dtype)

    def _tensor(self, name):
        return self._buffers[name] if self._specs[name].aux \
            else self._parameters[name]

    def infer_shape(self, x) -> None:
        """Set the shapes of this layer's parameters from an input."""
        raise NotImplementedError

    def _set_shape(self, name, shape):
        spec = self._specs[name]
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(spec.shape) or any(
                d and d != s for d, s in zip(spec.shape, shape)):
            raise MXNetError(f"inferred shape {shape} for {name} clashes "
                             f"with declared {spec.shape}")
        spec.shape = shape

    def _fill(self, name, initializer, generator):
        spec = self._specs[name]
        init = _init_mod.create(spec.init if spec.init is not None
                                else initializer)
        init(name, self._tensor(name), generator)

    def _init_params(self, initializer, device, generator,
                     force_reinit=False):
        """``Block.initialize`` for this layer: materialize and fill the
        parameters whose shape is known; record the plan for the rest."""
        self._init_plan = (initializer, generator, device)
        for name, spec in self._specs.items():
            if not is_lazy(self._tensor(name)):
                if force_reinit:             # refill where it lives
                    self._fill(name, initializer, generator)
                continue
            self._reset_lazy(name, spec, device)
            if spec.complete:
                self._tensor(name).materialize(spec.shape)
                self._fill(name, initializer, generator)

    def initialize_parameters(self, x, *args, **kwargs):
        """LazyModuleMixin hook, run before the first forward: infer the
        missing shapes from ``x`` and materialize with the recorded
        initializer."""
        if not self.has_uninitialized_params():
            return
        if self._init_plan is None:
            raise DeferredInitializationError(
                f"{type(self).__name__} has uninitialized parameters "
                f"{[n for n in self._specs if is_lazy(self._tensor(n))]}; "
                "call initialize() or load parameters first")
        self.infer_shape(x)
        initializer, generator, _ = self._init_plan
        with torch.no_grad():
            for name in self._specs:
                if is_lazy(self._tensor(name)):
                    self._tensor(name).materialize(self._specs[name].shape)
                    self._fill(name, initializer, generator)
