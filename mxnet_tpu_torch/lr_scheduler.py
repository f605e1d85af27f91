"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``,
ref ``python/mxnet/lr_scheduler.py``).

A scheduler maps the update count ``num_update`` to a learning rate, in
plain Python: the trainers evaluate it on the host and hand the value to
the step as a device scalar, so a schedule never recaptures a graph.
Every scheduler takes a warm-up over its first ``warmup_steps`` updates,
``"linear"`` from ``warmup_begin_lr`` to ``base_lr`` or ``"constant"``
at ``base_lr``. An optimizer given a scheduler sets its ``base_lr`` to
the optimizer's own learning rate.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """``num_update`` → learning rate, with a linear or constant warm-up
    (ref: lr_scheduler.py LRScheduler)."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = ((self.warmup_final_lr - self.warmup_begin_lr)
                   * num_update / max(self.warmup_steps, 1))
            return self.warmup_begin_lr + inc
        return self.warmup_final_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr * factor ** (num_update // step)``, at least
    ``stop_factor_lr`` (ref: FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * (self.factor ** (num_update // self.step))
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` once for every step in ``step`` that
    ``num_update`` has reached (ref: MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = sorted(step)
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        exp = sum(1 for s in self.step if s <= num_update)
        return self.base_lr * (self.factor ** exp)


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` from ``base_lr`` to ``final_lr``
    between the warm-up's end and ``max_update`` (ref: PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return (self.final_lr
                + (self.base_lr - self.final_lr) * (1 - frac) ** self.power)


class CosineScheduler(LRScheduler):
    """Cosine decay from ``base_lr`` to ``final_lr`` between the warm-up's
    end and ``max_update`` (ref: CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return (self.final_lr + (self.base_lr - self.final_lr)
                * (1 + math.cos(math.pi * frac)) / 2)
