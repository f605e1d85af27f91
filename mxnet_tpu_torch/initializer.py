"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

The same name-suffix dispatch as the reference: an initializer is called
with a parameter name and a tensor and fills the tensor; ``*weight`` goes
to ``_init_weight``, ``*bias``/``*beta``/``*running_mean`` to zeros,
``*gamma``/``*running_var`` to ones. Random fills draw from an explicit
``torch.Generator`` (PyTorch's default generator when none is given) on
the generator's device, then copy into the tensor, so one seed gives the
same weights on the CPU and on the card.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An :class:`Initializer` from an instance or a registered name."""
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str):
        if name.lower() not in _REGISTRY:
            raise MXNetError(f"unknown initializer {name!r}")
        return _REGISTRY[name.lower()](**kwargs)
    raise MXNetError(f"cannot create initializer from {name!r}")


class Initializer:
    """Base initializer with the reference's name-suffix dispatch."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, generator=None):
        name = str(name).lower()
        if name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith("bias") or name.endswith("beta") \
                or name.endswith("running_mean"):
            self._fill(arr, 0.0)
        elif name.endswith("gamma") or name.endswith("running_var"):
            self._fill(arr, 1.0)
        else:
            self._init_default(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def _init_default(self, name, arr, generator):
        self._init_weight(name, arr, generator)

    @staticmethod
    def _fill(arr, value):
        with torch.no_grad():
            arr.fill_(value)

    @staticmethod
    def _draw(arr, generator, fill):
        """Sample on the generator's device in float32 with ``fill(t,
        generator)``, then copy into ``arr``."""
        device = "cpu" if generator is None else generator.device
        tmp = torch.empty(tuple(arr.shape), dtype=torch.float32,
                          device=device)
        fill(tmp, generator)
        with torch.no_grad():
            arr.copy_(tmp)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


@register
class Uniform(Initializer):
    """U(-scale, scale) — the reference's default (scale=0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = float(scale)

    def _init_weight(self, name, arr, generator):
        self._draw(arr, generator, lambda t, g: t.uniform_(
            -self.scale, self.scale, generator=g))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = float(sigma)

    def _init_weight(self, name, arr, generator):
        self._draw(arr, generator,
                   lambda t, g: t.normal_(0.0, self.sigma, generator=g))


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = float(value)

    def _init_weight(self, name, arr, generator):
        self._fill(arr, self.value)

    _init_default = _init_weight


@register
class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


@register
class One(Constant):
    def __init__(self):
        super().__init__(1.0)


# the reference accepts 'zeros'/'ones' spellings (mx.init.Zero aliases)
_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Xavier(Initializer):
    """Glorot init (ref: initializer.py Xavier) — default for conv nets."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires >=2D weight, got {shape} "
                             f"for {name}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._draw(arr, generator,
                       lambda t, g: t.uniform_(-scale, scale, generator=g))
        else:
            self._draw(arr, generator,
                       lambda t, g: t.normal_(0.0, scale, generator=g))
