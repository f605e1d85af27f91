"""``mx.operator`` — custom operators written in Python (counterpart of
``mxnet_tpu/operator.py``, ref ``python/mxnet/operator.py`` CustomOp /
CustomOpProp and ``src/operator/custom/custom.cc``).

A user subclasses :class:`CustomOpProp` (shapes, types, the operator)
and :class:`CustomOp` (``forward``/``backward`` on numpy arrays through
``in_data``/``out_data`` and :meth:`CustomOp.assign`), registers the
prop with :func:`register`, and calls ``mx.nd.Custom(*inputs,
op_type=name, **params)``. As the JAX package runs them as host
callbacks, the port copies the inputs to the host, runs the user's
numpy, and copies the outputs back to the inputs' device; the user's
``backward`` is the ``torch.autograd.Function``'s backward, so a custom
op records under ``autograd.record()`` like a registry op.

A CUDA graph cannot hold a host round trip: inside a capture ``Custom``
raises naming the op (the JAX package embeds the callback in its
program). Run a block that calls it unhybridized.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .kernels._common import stream_capturing

__all__ = ["CustomOp", "CustomOpProp", "get", "register"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """The user's operator (ref: operator.py CustomOp): override
    ``forward`` and ``backward``, which work on numpy arrays and write
    their results with :meth:`assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        if req in ("write", "inplace", None):
            dst[...] = src
        elif req == "add":
            dst[...] += src
        elif req == "null":
            pass
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """Shape and type metadata of a custom op (ref: operator.py
    CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """ref: mx.operator.register — a class decorator for a
    :class:`CustomOpProp`."""
    def deco(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get(reg_name):
    if reg_name not in _CUSTOM_REGISTRY:
        raise MXNetError(f"custom op {reg_name!r} is not registered; known: "
                         f"{sorted(_CUSTOM_REGISTRY)}")
    return _CUSTOM_REGISTRY[reg_name]


def _host(t):
    """A tensor as a numpy array on the host (bfloat16 as float32: numpy
    has none here)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Custom(torch.autograd.Function):
    """One call of a custom op: the user's numpy forward and backward on
    host copies, the results copied back to the inputs' device."""

    @staticmethod
    def forward(ctx, call, *xs):
        operator, out_shapes, out_types = call
        ins = [_host(x) for x in xs]
        outs = [np.zeros(s, t) for s, t in zip(out_shapes, out_types)]
        operator.forward(is_train=True, req=["write"] * len(outs),
                         in_data=ins, out_data=outs, aux=[])
        device = xs[0].device if xs else torch.device("cpu")
        res = [torch.as_tensor(np.ascontiguousarray(o)).to(device)
               for o in outs]
        ctx.call, ctx.ins, ctx.outs = call, ins, outs
        ctx.in_meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(res)

    @staticmethod
    def backward(ctx, *gs):
        operator = ctx.call[0]
        ogs = [_host(g) for g in gs]
        igs = [np.zeros(tuple(s), _np_type(t)) for s, t, _ in ctx.in_meta]
        operator.backward(req=["write"] * len(igs), out_grad=ogs,
                          in_data=ctx.ins, out_data=ctx.outs, in_grad=igs,
                          aux=[])
        return (None, *(torch.as_tensor(np.ascontiguousarray(g))
                        .to(device=d, dtype=t)
                        for g, (_, t, d) in zip(igs, ctx.in_meta)))


def _np_type(dtype):
    return np.float32 if dtype == torch.bfloat16 else \
        torch.empty((), dtype=dtype).numpy().dtype


def _custom(*xs, op_type=None, **kwargs):
    """The ``Custom`` operator: run the registered prop ``op_type`` on
    tensors (its other parameters go to the prop's constructor)."""
    if stream_capturing():
        raise MXNetError(f"Custom op {op_type!r} inside a CUDA-graph "
                         "capture: its numpy forward runs on the host, "
                         "which a graph cannot hold; call it outside a "
                         "hybridized block or a captured step")
    prop = get(op_type)(**kwargs)
    in_shapes = [tuple(x.shape) for x in xs]
    in_types = [_np_type(x.dtype) for x in xs]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    _, out_types, _ = prop.infer_type(in_types)
    operator = prop.create_operator(None, in_shapes, in_types)
    call = (operator, [tuple(s) for s in out_shapes], list(out_types))
    outs = _Custom.apply(call, *xs)
    return outs[0] if len(outs) == 1 else outs


def _register_custom_op():
    """``Custom`` in the registry, and its wrapper in ``mx.nd`` (the
    namespace is generated before this module imports; the reference
    regenerates it on MXCustomOpRegister too)."""
    from .ops import registry
    from .ops.registry import OpParam
    registry.register(
        "Custom", num_inputs=-1, allow_unknown_params=True,
        params=[OpParam("op_type", str, None, required=True)],
        doc="Run a registered Python CustomOp (ref: src/operator/custom/"
            "custom.cc) on host copies of its inputs")(_custom)
    from . import ndarray as nd
    nd.Custom = nd._make_wrapper("Custom", registry.get("Custom"))
    nd.op.Custom = nd.Custom


_register_custom_op()
