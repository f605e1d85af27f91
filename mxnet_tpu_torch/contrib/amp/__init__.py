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

With op lists, ``init`` also installs a per-op cast policy
(:class:`_OpCastPolicy`, the reference's amp_cast graph pass): a listed
op's floating inputs are cast to the listed precision before it runs.
The hook sits on the registry's dispatch (``_dispatch.invoke``) and on
every op call of a Gluon block (``_dispatch.amp_cast``), the calls the
JAX package dispatches through its registry; an op's own internal calls
are not cast. A policy change bumps ``_dispatch.amp_epoch()``, which the
captured programs of ``hybridize()`` and ``ShardedTrainer`` key on.
"""
from __future__ import annotations

import torch

from ... import _dispatch
from ...base import MXNetError, as_torch_dtype, dtype_name
from ...ops.registry import get as get_op

__all__ = ["DynamicLossScaler", "amp_dtype", "convert_hybrid_block", "init",
           "init_trainer", "reset", "scale_loss", "unscale"]

_state = {"initialized": False, "dtype": None, "lists": None}

# Ops kept in fp32 whenever a per-op policy is active: the core of the
# reference's FP32_FUNCS (reductions, losses, norms, the exp/log family;
# ref: amp/lists/symbol_fp16.py), the JAX package's list.
_DEFAULT_FP32_OPS = (
    "softmax", "log_softmax", "SoftmaxOutput", "SoftmaxActivation",
    "norm", "mean", "sum", "exp", "log", "log2", "log10", "expm1",
    "log1p", "erf", "erfinv", "logsumexp", "smooth_l1", "MakeLoss",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput",
)


class _OpCastPolicy:
    """The reference's amp_cast graph pass at dispatch (ref:
    python/mxnet/contrib/amp/amp.py, lists/symbol_fp16.py): the floating
    inputs of a listed op are cast on the way in. The fp32 list (with
    :data:`_DEFAULT_FP32_OPS`) wins over a conditional entry, which wins
    over the target list; other ops keep their inputs."""

    def __init__(self, target_dtype, target_precision_ops,
                 conditional_fp32_ops, fp32_ops):
        self._target = as_torch_dtype(target_dtype)
        self._target_ops = frozenset(target_precision_ops or ())
        self._fp32_ops = frozenset(fp32_ops or ()) | \
            frozenset(_DEFAULT_FP32_OPS)
        cond = {}
        for op_name, param, values in (conditional_fp32_ops or ()):
            vals = values if isinstance(values, (list, tuple, set)) \
                else [values]
            cond.setdefault(op_name, []).append((param, set(vals)))
        self._conditional = cond

    @staticmethod
    def _cast_all(tensors, dtype):
        return [t.to(dtype) if isinstance(t, torch.Tensor)
                and t.is_floating_point() and t.dtype != dtype else t
                for t in tensors]

    def __call__(self, op_name, tensors, params):
        if op_name in self._fp32_ops:
            return self._cast_all(tensors, torch.float32)
        for param, vals in self._conditional.get(op_name, ()):
            value = params.get(param)
            if str(value) in vals or value in vals:
                return self._cast_all(tensors, torch.float32)
        if op_name in self._target_ops:
            return self._cast_all(tensors, self._target)
        return tensors


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """ref: amp.init — enable mixed precision process-wide at
    ``target_dtype`` ("bfloat16" or "float16").

    Without op lists, AMP is the one cast at the step boundary (read by
    ``ShardedTrainer``). With any of ``target_precision_ops`` /
    ``conditional_fp32_ops`` (``(op, param, [values])`` triples) /
    ``fp32_ops``, a per-op cast policy engages at dispatch; every listed
    name must be a registered operator. A re-``init`` without lists drops
    a policy installed before."""
    name = dtype_name(target_dtype)
    if name not in ("float16", "bfloat16"):
        raise MXNetError("AMP target_dtype must be float16 or bfloat16 "
                         "(bfloat16 recommended)")
    _state.update(initialized=True, dtype=name)
    if target_precision_ops or conditional_fp32_ops or fp32_ops:
        for op_name in [*(target_precision_ops or ()),
                        *(c[0] for c in conditional_fp32_ops or ()),
                        *(fp32_ops or ())]:
            get_op(op_name)       # an unknown name raises here
        policy = _OpCastPolicy(name, target_precision_ops,
                               conditional_fp32_ops, fp32_ops)
        _state["lists"] = policy
        _dispatch.set_amp_cast_hook(policy)
    else:
        _state["lists"] = None
        _dispatch.set_amp_cast_hook(None)


def reset():
    """Disable AMP and drop the per-op policy (a test helper; the
    reference has no uninit)."""
    _state.update(initialized=False, dtype=None, lists=None)
    _dispatch.set_amp_cast_hook(None)


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
