"""``mx.sym`` — the symbolic operator namespace (counterpart of
``mxnet_tpu/symbol/__init__.py``; ref python/mxnet/symbol/register.py).

Generated at import from the same registry as ``mx.nd``: every operator
composes lazily into a Symbol graph, in the sub-namespaces ``contrib``,
``random``, ``linalg``, ``op`` and ``_internal`` with ``mx.nd``'s
routing, plus the scalar-or-symbol binary helpers and the control-flow
entries (``contrib.foreach``, ``while_loop``, ``cond``). A name of the
JAX package that the port has not ported yet raises
:class:`~..base.MXNetError` naming its ROADMAP item, as in ``mx.nd``.
"""
from __future__ import annotations

import sys
import types

from ..ops import registry as _registry
from . import passes
from .control_flow import cond as _cf_cond
from .control_flow import foreach as _cf_foreach
from .control_flow import while_loop as _cf_while_loop
from .executor import Executor
from .passes import apply_pass, list_passes, register_pass
from .symbol import (_OP_INPUTS, Group, Symbol, Variable, _create, arange,
                     load, load_json, ones, var, zeros)

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "arange", "Executor", "eval_symbol",
           "passes", "apply_pass", "register_pass", "list_passes"]

_CONTRIB_TOP = ("BilinearResize2D", "AdaptiveAvgPooling2D")


def _make_wrapper(opname, op):
    param_order = [p.name for p in op.params]

    def wrapper(*args, name=None, attr=None, **kwargs):
        args = list(args)
        inputs = []
        while args and isinstance(args[0], Symbol):
            inputs.append(args.pop(0))
        # named inputs (data=, weight=, ...) as the reference takes them
        names, _ = _OP_INPUTS.get(opname, (["data"], 0))
        if not inputs and any(n in kwargs for n in names):
            for n in names:
                if n not in kwargs:
                    break
                inputs.append(kwargs.pop(n))
        for val, pname in zip(args, param_order):
            kwargs[pname] = val
        return _create(opname, inputs, kwargs, name=name)

    wrapper.__name__ = opname
    wrapper.__qualname__ = opname
    wrapper.__doc__ = op.signature_doc()
    return wrapper


def _deferred_getattr(prefixes):
    def __getattr__(name):
        if name.startswith("__"):
            raise AttributeError(name)
        for prefix in prefixes:
            if prefix + name in _registry.DEFERRED:
                raise _registry.deferred_error(prefix + name)
        raise AttributeError(f"mx.sym has no operator {name!r}")
    return __getattr__


def _new_module(name, prefixes):
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


def _expose():
    for opname in _registry.list_ops():
        fn = _make_wrapper(opname, _registry.get(opname))
        if opname.startswith("_contrib_"):
            setattr(contrib, opname[len("_contrib_"):], fn)
        elif opname.startswith("_random_"):
            setattr(random, opname[len("_random_"):], fn)
        elif opname.startswith("_sample_"):
            setattr(random, opname[1:], fn)
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


_expose()
_registry.install_binary_helpers(_this)

# the control-flow operators take Python callables: beside the registry
contrib.foreach = _cf_foreach
contrib.while_loop = _cf_while_loop
contrib.cond = _cf_cond


def eval_symbol(outputs, inputs, args, params):
    """Run ``outputs`` in predict mode (``SymbolBlock``'s forward):
    ``inputs`` (Symbols) bound to the tensors ``args``, the parameter
    variables to ``params`` (name -> tensor). Returns a tensor, or a
    list of them for several outputs."""
    values = {sym.name: a for sym, a in zip(inputs, args)}
    values.update(params)
    outs, _ = outputs._make_eval_fn(training=False)(values)
    return outs[0] if len(outs) == 1 else outs

