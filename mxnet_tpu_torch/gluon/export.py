"""Tracing a block into a Symbol (``HybridBlock.export``).

The JAX package traces ``hybrid_forward(F=mx.sym)``; the port's blocks
have a tensor ``forward`` that calls the registered operators' plain
functions. :func:`trace` runs ``forward`` once on PyTorch ``meta``
tensors (the block's parameters and buffers as meta copies, through
``torch.func.functional_call``, in predict mode) while a thread-local
recorder notes each operator call by its MXNet name, inputs and
parameters:

- the operator functions of ``ops`` that blocks call (``ops.nn``,
  ``ops.tensor``, ``ops.contrib``, ...) and every registered
  ``Operator.fn`` (``mx.nd`` inside a ``forward``) are wrapped for the
  trace; only the outermost call is a node, the calls inside an
  operator are its own business;
- a torch call made in a ``forward`` outside any operator (``x + y``,
  ``x[:, 0:1]``, ``reshape``, ``permute``, ``sigmoid``, ...) becomes the
  MXNet operator that computes the same thing (``elemwise_add`` or
  ``broadcast_add``, ``slice`` with ``None`` for whole axes, ...), or
  raises :class:`MXNetError` naming the block and the call: nothing is
  skipped silently, and a tensor that no traced call made cannot enter
  the graph.

Variables are the inputs (``data``, or ``data0``, ``data1``, ...) and the
block's ``collect_params()`` names; nodes are named after the block that
made them (``features_4_0_body_1_batchnorm0``). A meta tensor computes
nothing, so the trace needs no card and costs no device time.
"""
from __future__ import annotations

import contextlib
import inspect
import threading

import torch
from torch.overrides import TorchFunctionMode

from ..base import MXNetError

__all__ = ["trace"]

_local = threading.local()

# operator functions of the ops modules registered through a lambda or
# an adapter: module attribute -> registry name
_ADAPTED = {
    "nn": {"fully_connected": "FullyConnected", "convolution": "Convolution",
           "deconvolution": "Deconvolution", "pooling": "Pooling",
           "batch_norm": "BatchNorm", "leaky_relu": "LeakyReLU",
           "layer_norm": "LayerNorm", "dropout": "Dropout",
           "embedding": "Embedding", "softmax_output": "SoftmaxOutput",
           "activation": "Activation", "group_norm": "GroupNorm",
           "instance_norm": "InstanceNorm", "softmax": "softmax"},
    "tensor": {"flatten": "Flatten", "concat": "Concat", "stack": "stack",
               "reshape": "reshape", "transpose": "transpose",
               "slice_axis": "slice_axis", "slice_nd": "slice"},
    "contrib": {"conv_epilogue": "_contrib_conv_epilogue",
                "matmul_epilogue": "_contrib_matmul_epilogue",
                "fused_self_attention": "_contrib_fused_self_attention",
                "flash_attention": "_contrib_flash_attention",
                "arange_like": "arange_like"},
}
# arguments the dispatch supplies, never hyperparameters
_RUNTIME_ARGS = ("training", "generator", "bits", "ctx")


def _ops_modules():
    import importlib
    from .. import ops
    names = ["contrib", "elemwise", "nn", "random", "sequence", "tensor"]
    return {n: importlib.import_module(f"{ops.__name__}.{n}")
            for n in names}


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat_tensors(v)]
    return []


class _Recorder:
    def __init__(self, paths):
        self.syms = {}          # id(tensor) -> (tensor, Symbol)
        self.depth = 0
        self.paths = paths      # id(module) -> structural path
        self.stack = [""]
        self.counts = {}

    # -- naming and lookup ---------------------------------------------------
    def where(self):
        return self.stack[-1] or "the top block"

    def node_name(self, opname):
        prefix = self.stack[-1].replace(".", "_")
        hint = opname.lower().lstrip("_")
        key = (prefix, hint)
        n = self.counts.get(key, 0)
        self.counts[key] = n + 1
        return f"{prefix}_{hint}{n}" if prefix else f"{hint}{n}"

    def bind(self, t, sym):
        self.syms[id(t)] = (t, sym)

    def known(self, t):
        hit = self.syms.get(id(t))
        return hit is not None and hit[0] is t

    def sym_of(self, t, what):
        hit = self.syms.get(id(t))
        if hit is None or hit[0] is not t:
            raise MXNetError(f"export: {self.where()} passes {what} a tensor "
                             "that no traced operator made (a constant "
                             "built in forward, or a torch call the "
                             "recorder does not map)")
        return hit[1]

    # -- nodes ---------------------------------------------------------------
    def node(self, opname, inputs, params, out):
        """Add ``opname`` over the tensors ``inputs`` with ``params``; map
        the tensors of ``out`` to its outputs. Returns ``out``, with an
        output that is one of the inputs replaced by a view (a new
        tensor to map)."""
        from ..symbol.symbol import Symbol, _create
        syms = [self.sym_of(t, opname) for t in inputs]
        sym = _create(opname, syms, params, name=self.node_name(opname))
        ids = {id(t) for t in inputs}

        def fresh(o):
            if id(o) not in ids:
                return o
            self.depth += 1          # the view is no node of its own
            try:
                return o.view_as(o)
            finally:
                self.depth -= 1
        if isinstance(out, torch.Tensor):
            out = fresh(out)
            self.bind(out, Symbol(sym._node, 0))
            return out
        out = type(out)(fresh(o) if isinstance(o, torch.Tensor) else o
                        for o in out)
        for i, o in enumerate(out):
            if isinstance(o, torch.Tensor):
                self.bind(o, Symbol(sym._node, i))
        return out

    def op_call(self, fn, sig, opname, args, kwargs):
        """One call of an operator function at depth 0."""
        bound = sig.bind(*args, **kwargs)
        inputs, params = [], {}
        for pname, value in bound.arguments.items():
            kind = sig.parameters[pname].kind
            if kind is inspect.Parameter.VAR_KEYWORD:
                params.update({k: v for k, v in value.items()
                               if k not in _RUNTIME_ARGS})
            elif isinstance(value, torch.Tensor):
                inputs.append(value)
            elif isinstance(value, (tuple, list)) and value and all(
                    isinstance(v, torch.Tensor) for v in value):
                inputs.extend(value)
            elif value is not None and pname not in _RUNTIME_ARGS:
                params[pname] = value
        from ..ops import registry
        op = registry.get(opname)
        unknown = sorted(set(params) - {p.name for p in op.params})
        if unknown and not op.allow_unknown_params:
            raise MXNetError(f"export: {self.where()} calls {opname} with "
                             f"{unknown}, which the operator does not take")
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        return self.node(opname, inputs, params, out)


def _wrap(fn, opname):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        sig = None

    def traced(*args, **kwargs):
        rec = getattr(_local, "recorder", None)
        if rec is None or rec.depth > 0 or sig is None:
            return fn(*args, **kwargs)
        return rec.op_call(fn, sig, opname, args, kwargs)
    traced.__wrapped__ = fn
    return traced


# -- torch calls outside the operators ---------------------------------------

_BINARY = {  # torch names -> (same shape, broadcast, scalar, reflected)
    "add": ("elemwise_add", "broadcast_add", "_plus_scalar", "_plus_scalar"),
    "sub": ("elemwise_sub", "broadcast_sub", "_minus_scalar",
            "_rminus_scalar"),
    "mul": ("elemwise_mul", "broadcast_mul", "_mul_scalar", "_mul_scalar"),
    "div": ("elemwise_div", "broadcast_div", "_div_scalar", "_rdiv_scalar"),
}
_UNARY = {"sigmoid": "sigmoid", "relu": "relu", "tanh": "tanh",
          "exp": "exp", "neg": "negative", "sqrt": "sqrt", "abs": "abs"}
_IDENTITY = ("contiguous", "clone", "detach")


_ALIAS = {"truediv": "div", "true_divide": "div", "divide": "div",
          "multiply": "mul", "subtract": "sub", "negative": "neg"}


def _base_name(func):
    """(torch function's base name, reflected): ``__rtruediv__`` ->
    ("div", True), ``__iadd__`` -> ("add", False)."""
    name = getattr(func, "__name__", str(func)).strip("_")
    for lead, reflected in (("r", True), ("i", False)):
        rest = _ALIAS.get(name[1:], name[1:])
        if name.startswith(lead) and rest in _BINARY:
            return rest, reflected
    return _ALIAS.get(name, name), False


def _slice_params(key, ndim):
    """``x[key]`` of slices (and one Ellipsis) as the ``slice`` op's
    begin / end / step, ``None`` for a whole axis; None if the key holds
    anything else."""
    key = key if isinstance(key, tuple) else (key,)
    if sum(k is Ellipsis for k in key) > 1:
        return None
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (ndim - len(key) + 1) + key[i + 1:]
    if not all(isinstance(k, slice) for k in key):
        return None
    begin = tuple(k.start for k in key)
    end = tuple(k.stop for k in key)
    step = tuple(k.step for k in key)
    return {"begin": begin, "end": end,
            "step": None if all(s is None for s in step) else step}


class _Mode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = getattr(_local, "recorder", None)
        if rec is None or rec.depth > 0:
            return func(*args, **kwargs)
        tracked = [t for t in _flat_tensors((args, kwargs)) if rec.known(t)]
        rec.depth += 1
        try:
            out = func(*args, **kwargs)
        finally:
            rec.depth -= 1
        if not tracked or not _flat_tensors(out):
            return out
        if isinstance(out, torch.Tensor) and rec.known(out):
            return out                   # the same tensor handed back
        return _torch_node(rec, func, args, kwargs, out)


def _torch_node(rec, func, args, kwargs, out):
    name, reflected = _base_name(func)
    x = args[0] if args else None
    if name in _IDENTITY or (name == "to" and isinstance(out, torch.Tensor)
                             and out.dtype == x.dtype):
        rec.bind(out, rec.sym_of(x, name))
        return out
    if name == "to" or name in ("float", "half", "bfloat16"):
        from ..base import dtype_name
        return rec.node("Cast", [x], {"dtype": dtype_name(out.dtype)}, out)
    if name in _BINARY and len(args) == 2 and not kwargs:
        same, bcast, scalar, rscalar = _BINARY[name]
        a, b = args
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            a, b = (b, a) if reflected else (a, b)
            op = same if a.shape == b.shape else bcast
            return rec.node(op, [a, b], {}, out)
        t, s = (a, b) if isinstance(a, torch.Tensor) else (b, a)
        flip = reflected or not isinstance(a, torch.Tensor)
        return rec.node(rscalar if flip else scalar, [t],
                        {"scalar": float(s)}, out)
    if name in _UNARY and len(args) == 1 and not kwargs:
        return rec.node(_UNARY[name], [x], {}, out)
    if name in ("reshape", "view"):
        shape = args[1:] if len(args) > 2 or not isinstance(
            args[1] if len(args) > 1 else None, (tuple, list, torch.Size)) \
            else args[1]
        shape = kwargs.get("shape", shape)
        return rec.node("reshape", [x], {"shape": tuple(shape)}, out)
    if name == "permute":
        axes = args[1:] if len(args) > 2 or isinstance(args[1], int) \
            else args[1]
        return rec.node("transpose", [x], {"axes": tuple(axes)}, out)
    if name in ("transpose", "swapaxes") and len(args) == 3:
        return rec.node("SwapAxis", [x], {"dim1": args[1], "dim2": args[2]},
                        out)
    if name == "getitem" and len(args) == 2:
        params = _slice_params(args[1], x.ndim)
        if params is not None:
            return rec.node("slice", [x], params, out)
    if name in ("cat", "concat", "stack") and args and \
            isinstance(args[0], (tuple, list)):
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        key = "dim" if name != "stack" else "axis"
        return rec.node("Concat" if name != "stack" else "stack",
                        list(args[0]), {key: dim}, out)
    raise MXNetError(f"export: {rec.where()} calls torch "
                     f"{getattr(func, '__name__', func)!r} outside the "
                     "registered operators, which the exporter does not "
                     "map to an MXNet operator")


@contextlib.contextmanager
def _patched_ops():
    """Wrap the operator functions of the ops modules and every
    registered ``Operator.fn`` for the trace; restore them after."""
    from ..ops import registry
    ops_by_fn = {}
    for name in registry.list_ops():
        op = registry.get(name)
        ops_by_fn.setdefault(id(op.fn), (op.fn, op.name))
    saved = []
    try:
        for mod_name, mod in _ops_modules().items():
            adapted = _ADAPTED.get(mod_name, {})
            for attr, value in list(vars(mod).items()):
                if attr.startswith("__") or not callable(value):
                    continue
                opname = adapted.get(attr)
                if opname is None and id(value) in ops_by_fn \
                        and ops_by_fn[id(value)][0] is value:
                    opname = ops_by_fn[id(value)][1]
                if opname is None:
                    continue
                saved.append((mod, attr, value))
                setattr(mod, attr, _wrap(value, opname))
        seen = set()
        for name in registry.list_ops():
            op = registry.get(name)
            if id(op) in seen:
                continue
            seen.add(id(op))
            saved.append((op, "fn", op.fn))
            op.fn = _wrap(op.fn, op.name)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


_trace_lock = threading.Lock()


def trace(block, input_specs, input_names):
    """The Symbol of ``block``'s predict-mode forward on inputs of
    ``input_specs`` ([(shape, dtype)]) named ``input_names``, its
    variables named by ``collect_params()``. Outputs in a tuple or list
    become a Group."""
    from torch.nn.parameter import is_lazy

    from .. import autograd
    from ..symbol.symbol import Group, var
    from .cached_graph import _inside
    state = block.state_dict(keep_vars=True)
    lazy = [k for k, v in state.items() if is_lazy(v)]
    if lazy:
        raise MXNetError(f"export: parameters {lazy[:3]} are not "
                         "initialized; initialize the block (or run a "
                         "forward) before export")
    paths = {id(m): p for p, m in block.named_modules()}
    rec = _Recorder(paths)
    meta = {}
    for name, t in state.items():
        m = torch.empty(t.shape, dtype=t.dtype, device="meta")
        meta[name] = m
        rec.bind(m, var(name))
    inputs = []
    for (shape, dtype), name in zip(input_specs, input_names):
        t = torch.empty(shape, dtype=dtype, device="meta")
        rec.bind(t, var(name))
        inputs.append(t)

    def pre(module, args):
        rec.stack.append(rec.paths.get(id(module), rec.stack[-1]))

    def post(module, args, out):
        rec.stack.pop()

    from torch.nn.modules import module as _module
    with _trace_lock, _patched_ops():
        h1 = _module.register_module_forward_pre_hook(
            lambda m, a: pre(m, a) if getattr(_local, "recorder", None)
            is rec else None)
        h2 = _module.register_module_forward_hook(
            lambda m, a, o: post(m, a, o) if getattr(_local, "recorder",
                                                     None) is rec else None)
        _local.recorder = rec
        try:
            with _inside(), autograd.predict_mode(), torch.no_grad(), \
                    _Mode():
                out = torch.func.functional_call(block, meta, tuple(inputs))
        finally:
            _local.recorder = None
            h1.remove()
            h2.remove()
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    syms = []
    for o in outs:
        if not isinstance(o, torch.Tensor):
            raise MXNetError(f"export: the block returns a "
                             f"{type(o).__name__}, not tensors")
        syms.append(rec.sym_of(o, "its output"))
    return syms[0] if len(syms) == 1 else Group(syms)
