"""AMP — automatic mixed precision (counterpart of
``mxnet_tpu/contrib/amp``, ref ``python/mxnet/contrib/amp/amp.py``).

As in the JAX package, mixed precision is one cast at the training
step's boundary: :func:`init` sets the process-wide compute dtype that
``parallel.ShardedTrainer`` reads before each step (fp32 master weights,
the forward and backward in bfloat16 or float16, the loss and the update
in fp32), and fp16 keeps the reference's :class:`DynamicLossScaler`
(skip the step and halve the scale on overflow). With the eager
``gluon.Trainer``, :func:`init_trainer` attaches a scaler and
:func:`scale_loss` scales the loss for the backward; the trainer checks
the gradients with one fused reduction and one host read per step in
fp16, and not at all in bf16.

The per-op cast policy of ``init`` with op lists (a cast hook on the op
registry's dispatch, ``_dispatch.set_amp_cast_hook``, with the
reference's fp16/bf16 op lists) is not ported yet: ``init`` with op
lists raises.
"""
from __future__ import annotations

import torch

from ...base import MXNetError, dtype_name

__all__ = ["DynamicLossScaler", "amp_dtype", "convert_hybrid_block", "init",
           "init_trainer", "reset", "scale_loss", "unscale"]

_state = {"initialized": False, "dtype": None}


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """ref: amp.init — enable mixed precision process-wide at
    ``target_dtype`` ("bfloat16" or "float16"). Op lists (a per-op cast
    policy) raise: the policy over the registry's dispatch is ROADMAP
    Queue 1 item 6's rest."""
    name = dtype_name(target_dtype)
    if name not in ("float16", "bfloat16"):
        raise MXNetError("AMP target_dtype must be float16 or bfloat16 "
                         "(bfloat16 recommended)")
    if target_precision_ops or conditional_fp32_ops or fp32_ops:
        raise MXNetError("amp.init with op lists (a per-op cast policy "
                         "over the op registry's dispatch) is not ported "
                         "yet (ROADMAP Queue 1 item 6's rest); call "
                         f"amp.init({name!r}) for the cast at the step "
                         "boundary")
    _state.update(initialized=True, dtype=name)


def reset():
    """Disable AMP (a test helper; the reference has no uninit)."""
    _state.update(initialized=False, dtype=None)


def amp_dtype():
    """The active AMP compute dtype name, or None (read by
    ``ShardedTrainer``)."""
    return _state["dtype"] if _state["initialized"] else None


class DynamicLossScaler:
    """ref: amp.py DynamicLossScaler — grow the scale after
    ``scale_window`` steps without overflow, halve it (to at least 1) and
    skip the step on one."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0


def init_trainer(trainer):
    """ref: amp.init_trainer — attach a loss scaler to a gluon Trainer."""
    if not _state["initialized"]:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    trainer._amp_loss_scaler = DynamicLossScaler()
    return trainer


class _ScaledLoss:
    def __init__(self, loss, scaler):
        self._loss = loss
        self._scaler = scaler

    def __enter__(self):
        s = self._scaler.loss_scale
        if isinstance(self._loss, (list, tuple)):
            return [l * s for l in self._loss]
        return self._loss * s

    def __exit__(self, *exc):
        return False


def _scaler_of(trainer):
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("trainer was not passed through amp.init_trainer")
    return scaler


def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as L: autograd.backward(L)``
    (ref: amp.scale_loss). ``Trainer.step`` divides the scale back out
    through ``rescale_grad``."""
    scaler = _scaler_of(trainer)
    trainer._scale = 1.0 / scaler.loss_scale
    return _ScaledLoss(loss, scaler)


def unscale(trainer):
    """Divide the gradients by the current loss scale in place."""
    scaler = _scaler_of(trainer)
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            if p.grad is not None:
                p.grad.mul_(inv)
    trainer._scale = 1.0


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None):
    """Cast a block's parameters for low-precision inference (ref:
    amp.convert_hybrid_block)."""
    block.cast(target_dtype)
    return block
