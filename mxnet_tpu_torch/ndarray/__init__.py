"""``mx.nd`` — the imperative operator namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``, ref ``python/mxnet/ndarray/
register.py``).

Generated at import from the op registry: every registered operator gets
a wrapper whose docstring comes from its :class:`~..ops.registry.OpParam`
rows, in the reference's sub-namespaces (``nd.random``, ``nd.linalg``,
``nd.contrib``, ``nd.op``, ``nd._internal``), with the JAX package's
routing rules. A wrapper takes NDArrays (and returns NDArrays), tensors
(and returns tensors: a block's ``forward`` can use ``F = mx.nd``), or
no array (creation ops and samplers, which return NDArrays). A name of
the JAX package that the port has not ported yet raises
:class:`~..base.MXNetError` naming its ROADMAP item. The control-flow
operators (``contrib.foreach``, ``while_loop``, ``cond``) take Python
callables and the sparse storage types (``nd.sparse``) are plain
modules beside the registry, as in the JAX package.
"""
from __future__ import annotations

import sys
import types

import numpy as _np
import torch

from .. import _dispatch, ops  # noqa: F401 - ops: every op registered
from ..ops import registry as _registry
from .ndarray import (NDArray, _load_tensors, arange, array, concat, empty,
                      eye, full, imdecode, linspace, load, moveaxis,
                      onehot_encode, ones, save, stack, waitall, zeros)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "concat", "stack", "save", "load", "waitall",
           "random", "linalg", "contrib", "op", "_internal", "zeros_like",
           "ones_like", "moveaxis", "onehot_encode", "dot", "split",
           "sparse", "CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array"]

_ARRAYLIKE = (NDArray, torch.Tensor, _np.ndarray, list)
_CONTRIB_TOP = ("BilinearResize2D", "AdaptiveAvgPooling2D")


def _make_wrapper(opname: str, op: _registry.Operator):
    param_order = [p.name for p in op.params]

    def wrapper(*args, out=None, name=None, **kwargs):
        args = list(args)
        if op.num_inputs == 0:
            inputs = []
        elif op.num_inputs == -1:
            inputs = []
            while args and isinstance(args[0], _ARRAYLIKE):
                inputs.append(args.pop(0))
        else:
            inputs, args = args[:op.num_inputs], args[op.num_inputs:]
        # remaining positionals map onto the declared params in order
        if len(args) > len(param_order):
            raise TypeError(f"{opname}: too many positional arguments")
        for val, pname in zip(args, param_order):
            if pname in kwargs:
                raise TypeError(f"{opname}: got multiple values for {pname!r}")
            kwargs[pname] = val
        return _dispatch.invoke(op, inputs, kwargs, out=out)

    wrapper.__name__ = opname
    wrapper.__qualname__ = opname
    wrapper.__doc__ = op.signature_doc()
    return wrapper


def _deferred_getattr(prefixes):
    """A module ``__getattr__``: a deferred operator name (under one of
    ``prefixes``) raises naming its ROADMAP item; anything else is an
    AttributeError."""
    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        for prefix in prefixes:
            if prefix + name in _registry.DEFERRED:
                raise _registry.deferred_error(prefix + name)
        raise AttributeError(f"mx.nd has no operator {name!r}")
    return __getattr__


def _new_module(name: str, prefixes) -> types.ModuleType:
    mod = types.ModuleType(f"{__name__}.{name}")
    mod.__getattr__ = _deferred_getattr(prefixes)
    sys.modules[mod.__name__] = mod
    return mod


random = _new_module("random", ("_random_", "_sample_"))
linalg = _new_module("linalg", ("_linalg_",))
contrib = _new_module("contrib", ("_contrib_", ""))
op = _new_module("op", ("",))
_internal = _new_module("_internal", ("",))

_this = sys.modules[__name__]
__getattr__ = _deferred_getattr(("",))


def _as_method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


def _expose():
    for opname in _registry.list_ops():
        operator = _registry.get(opname)
        fn = _make_wrapper(opname, operator)
        if opname.startswith("_contrib_"):
            setattr(contrib, opname[len("_contrib_"):], fn)
        elif opname.startswith("_random_"):
            setattr(random, opname[len("_random_"):], fn)
        elif opname.startswith("_sample_"):
            setattr(random, opname[1:], fn)      # nd.random.sample_uniform
            setattr(_this, opname[1:], fn)       # nd.sample_uniform
        elif opname.startswith("_linalg_"):
            setattr(linalg, opname[len("_linalg_"):], fn)
        elif opname.startswith("_"):
            setattr(_internal, opname, fn)
        elif opname in _CONTRIB_TOP:
            setattr(contrib, opname, fn)
        else:
            if not hasattr(_this, opname):
                setattr(_this, opname, fn)
            setattr(op, opname, fn)
        # NDArray methods for the one- and two-input lower-case ops
        if (operator.num_inputs in (1, 2) and opname[0].isalpha()
                and opname[0].islower() and not hasattr(NDArray, opname)):
            setattr(NDArray, opname, _as_method(fn))


_expose()
_registry.install_binary_helpers(_this)

from . import sparse                                  # noqa: E402
from .sparse import (CSRNDArray, RowSparseNDArray,    # noqa: E402
                     csr_matrix, row_sparse_array)
from ..ops import control_flow as _control_flow      # noqa: E402

contrib.foreach = _control_flow.foreach
contrib.while_loop = _control_flow.while_loop
contrib.cond = _control_flow.cond

random.shuffle = getattr(_internal, "_shuffle")
random.multinomial = random.sample_multinomial

zeros_like = getattr(_this, "zeros_like")
ones_like = getattr(_this, "ones_like")


def dot(lhs, rhs, transpose_a=False, transpose_b=False, out=None):
    """nd.dot — positional transpose flags (ref: tensor/dot.cc)."""
    return _dispatch.invoke("dot", [lhs, rhs],
                            dict(transpose_a=transpose_a,
                                 transpose_b=transpose_b), out=out)


def split(data, num_outputs, axis=1, squeeze_axis=False):
    """nd.split (SliceChannel)."""
    return _dispatch.invoke("SliceChannel", [data],
                            dict(num_outputs=num_outputs, axis=axis,
                                 squeeze_axis=squeeze_axis))
