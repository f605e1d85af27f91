"""Eager op dispatch (counterpart of ``mxnet_tpu/_dispatch.py``, ref
``src/imperative/imperative.cc`` Imperative::Invoke).

:func:`invoke` coerces an operator's hyperparameters, hands it its
generator (``needs_rng``: the device's generator of ``mx.random``, never
torch's global one, so ``mx.random.seed`` reproduces the draws and a
CUDA-graph capture registers it) and its mode (``needs_mode``:
``autograd.is_training()``), runs it on tensors and wraps the result.
PyTorch's autograd records the graph, so there is no tape to wire: an
op on NDArrays records exactly when ``autograd.is_recording()``, as in
MXNet; an op on tensors leaves the grad mode as the caller set it.

Return kind follows the inputs: NDArray in, NDArray out; ``torch.Tensor``
in, tensor out (so a block's ``forward`` can use ``F = mx.nd`` on the
tensors it holds); no array input (creation ops, samplers), NDArray.

``out=`` writes the result into the target's storage in place (a
``copy_`` under ``no_grad``), as MXNet writes into the buffer, so
``nd.sgd_update(w, g, lr=.1, out=w)`` reaches the tensor ``w`` wraps
(a Gluon Parameter). The JAX package rebinds the handle instead, because
its arrays are immutable. While recording, a result that carries a
recorded graph rebinds an NDArray target (the graph goes on), and a
target that is a leaf requiring a gradient raises, as MXNet refuses it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import autograd as _autograd
from . import engine
from . import random as _random
from .base import MXNetError
from .context import Context, current_context, resolve_device
from .ops.registry import get as get_op

__all__ = ["amp_cast", "amp_epoch", "as_device", "invoke",
           "set_amp_cast_hook", "to_tensor"]

# Per-op AMP cast policy (ref: the amp_cast pairs of python/mxnet/contrib/
# amp/lists/symbol_fp16.py): installed by contrib.amp.init with op lists,
# called as hook(op_name, tensors, params) -> tensors.
_amp_cast_hook = None
_amp_epoch = 0      # bumped on every policy change: program caches key on it


def set_amp_cast_hook(fn):
    global _amp_cast_hook, _amp_epoch
    _amp_cast_hook = fn
    _amp_epoch += 1


def amp_epoch():
    """Monotonic counter of AMP-policy changes."""
    return _amp_epoch


def amp_cast(op_name, *tensors, **params):
    """The per-op AMP policy's inputs for one call of ``op_name`` (a
    registry name) made outside the registry's dispatch: a Gluon block's
    op call, where the JAX package's ``F.<op>`` dispatches. Returns the
    tensors as a list, unchanged when no policy is set (None entries,
    an absent bias, pass through)."""
    if _amp_cast_hook is None:
        return list(tensors)
    return _amp_cast_hook(op_name, list(tensors), params)


def as_device(ctx) -> torch.device:
    """A ``ctx`` argument (Context, ``'gpu(0)'``, ``'cpu'``, torch device,
    None for the current context) as a ``torch.device``."""
    if isinstance(ctx, str) and "(" in ctx:
        kind, _, rest = ctx.partition("(")
        ctx = Context(kind, int(rest.rstrip(")")))
    elif isinstance(ctx, str) and ctx in ("cpu", "gpu"):
        ctx = Context(ctx, 0)
    return resolve_device(ctx)


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def to_tensor(x, device) -> torch.Tensor:
    """A non-array operand (numpy array, list, Python number) as a tensor
    on ``device``. 64-bit numpy values become 32-bit, as ``jnp.asarray``
    makes them with JAX's default x64 off."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype in _NARROW:
        a = a.astype(_NARROW[a.dtype])
    return torch.as_tensor(a, device=device)


def _unwrap(inputs, params):
    """(tensors, any NDArray among the inputs, any array among them, the
    device): arrays are unwrapped, other operands converted onto the
    arrays' device, else the ``ctx`` parameter's, else the current
    context's."""
    from .ndarray.ndarray import NDArray
    nd_in = any(isinstance(x, NDArray) for x in inputs)
    device = None
    for x in inputs:
        if isinstance(x, (NDArray, torch.Tensor)):
            device = (x._data if isinstance(x, NDArray) else x).device
            break
    array_in = device is not None
    if device is None:
        ctx = params.get("ctx")
        device = as_device(ctx if ctx is not None else current_context())
    tensors = [x._data if isinstance(x, NDArray) else to_tensor(x, device)
               for x in inputs]
    return tensors, nd_in, array_in, device


def invoke(op, inputs: Sequence, kwargs: dict, out=None):
    """Run operator ``op`` (an Operator or a name) on ``inputs``; returns
    an NDArray or tensor, or a list of them for several outputs."""
    from .ndarray.ndarray import NDArray
    if isinstance(op, str):
        op = get_op(op)
    params = op.coerce_params(kwargs)
    tensors, nd_in, array_in, device = _unwrap(list(inputs), params)
    call = dict(params)
    if "ctx" in call:
        call["ctx"] = device
    if op.needs_rng:
        call["generator"] = _random.sampler_generator(device)
    if op.needs_mode:
        call["training"] = _autograd.is_training()
    if _amp_cast_hook is not None:
        tensors = _amp_cast_hook(op.name, tensors, params)
    if nd_in or not array_in:
        grad = _autograd.is_recording() and op.differentiable
    else:
        grad = torch.is_grad_enabled() and op.differentiable
    with torch.set_grad_enabled(grad):
        res = op.fn(*tensors, **call)
    outs = list(res) if isinstance(res, (tuple, list)) else [res]
    engine.on_op_done(outs)
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for tgt, res_t in zip(targets, outs):
            _write(tgt, res_t)
        return out
    wrap = nd_in or not array_in
    results = [NDArray(o) if wrap else o for o in outs]
    if op.n_outputs(params) == 1 or len(results) == 1:
        return results[0]
    return results


def _write(target, value):
    """``out=``: the value into ``target`` (an NDArray or a tensor)."""
    from .ndarray.ndarray import NDArray
    t = target._data if isinstance(target, NDArray) else target
    recording = _autograd.is_recording()
    if recording and t.requires_grad and t.is_leaf:
        raise MXNetError("out= names an array that records its gradient "
                         "(attach_grad or a Parameter) inside "
                         "autograd.record(): MXNet refuses to overwrite it")
    if recording and value.requires_grad:
        if not isinstance(target, NDArray):
            raise MXNetError("out= of a recorded result needs an NDArray "
                             "target inside autograd.record()")
        target._data = value
        return
    with torch.no_grad():
        t.copy_(value)
