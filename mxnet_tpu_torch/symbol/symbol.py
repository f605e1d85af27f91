"""Symbol — the lazy graph-composition API (counterpart of
``mxnet_tpu/symbol/symbol.py``; ref python/mxnet/symbol/symbol.py and
the NNVM graph of src/c_api/c_api_symbolic.cc).

A Symbol is one output slot of a small immutable node (op name, input
symbols, hyperparameters), the DAG NNVM builds. Auto-created parameter
variables follow the reference's naming (``fullyconnected0_weight``), so
``list_arguments`` orders and checkpoints interoperate with the JAX
package, and ``tojson`` / ``load_json`` read and write its schema.

Running a graph (:meth:`Symbol._make_eval_fn`) calls each node's
registered plain function on tensors: the hand-written kernels are
reached as in ``mx.nd`` (K1 through ``BatchNorm(act_type=)`` and
``_contrib_conv_epilogue``, K2 through ``_contrib_matmul_epilogue``, K3
through the attention operators above 1024 keys). ``infer_shape`` runs
the same functions on PyTorch ``meta`` tensors node by node, where the
JAX package runs ``jax.eval_shape``: nothing is computed and no card is
needed (the kernel entries take their plain versions on a meta tensor).
"""
from __future__ import annotations

import ast
import json
import threading

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError
from ..context import current_context
from ..ops import registry as _registry
from . import control_flow as _cflow

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "arange"]

# input-slot names and the number of trailing aux inputs per layer op
# (the reference's FListInputNames / FMutateInputs)
_OP_INPUTS = {
    "FullyConnected": (["data", "weight", "bias"], 0),
    "Convolution": (["data", "weight", "bias"], 0),
    "Deconvolution": (["data", "weight", "bias"], 0),
    "BatchNorm": (["data", "gamma", "beta", "moving_mean", "moving_var"], 2),
    "LayerNorm": (["data", "gamma", "beta"], 0),
    "GroupNorm": (["data", "gamma", "beta"], 0),
    "InstanceNorm": (["data", "gamma", "beta"], 0),
    "Embedding": (["data", "weight"], 0),
    "_contrib_DeformableConvolution": (
        ["data", "offset", "weight", "bias"], 0),
    "_contrib_ModulatedDeformableConvolution": (
        ["data", "offset", "mask", "weight", "bias"], 0),
    "RNN": (["data", "parameters", "state", "state_cell"], 0),
    "LeakyReLU": (["data", "gamma"], 0),
    "SoftmaxOutput": (["data", "label"], 0),
    "LinearRegressionOutput": (["data", "label"], 0),
    "MAERegressionOutput": (["data", "label"], 0),
    "LogisticRegressionOutput": (["data", "label"], 0),
}
# params that drop a trailing input (no_bias drops bias)
_SUPPRESS = {"no_bias": "bias"}


def _infer_param_shapes(opname, attrs, data_shape):
    """Parameter shapes implied by the data shape: what each reference
    op's InferShape does for its weights (FullyConnected, Convolution,
    BatchNorm, the norms, Embedding, the loss heads' labels, PReLU)."""
    out = {}
    if data_shape is None:
        return out
    d = tuple(data_shape)
    if opname == "FullyConnected":
        flatten = attrs.get("flatten", True)
        in_dim = int(np.prod(d[1:])) if flatten else d[-1]
        out["weight"] = (attrs["num_hidden"], in_dim)
        out["bias"] = (attrs["num_hidden"],)
    elif opname == "Convolution":
        kernel = tuple(attrs["kernel"])
        ng = attrs.get("num_group", 1) or 1
        out["weight"] = (attrs["num_filter"], d[1] // ng) + kernel
        out["bias"] = (attrs["num_filter"],)
    elif opname == "Deconvolution":
        kernel = tuple(attrs["kernel"])
        ng = attrs.get("num_group", 1) or 1
        out["weight"] = (d[1], attrs["num_filter"] // ng) + kernel
        out["bias"] = (attrs["num_filter"],)
    elif opname == "BatchNorm":
        c = d[attrs.get("axis", 1)]
        for s in ("gamma", "beta", "moving_mean", "moving_var"):
            out[s] = (c,)
    elif opname == "LayerNorm":
        c = d[attrs.get("axis", -1)]
        out["gamma"] = (c,)
        out["beta"] = (c,)
    elif opname in ("GroupNorm", "InstanceNorm"):
        out["gamma"] = (d[1],)
        out["beta"] = (d[1],)
    elif opname == "Embedding":
        out["weight"] = (attrs["input_dim"], attrs["output_dim"])
    elif opname == "SoftmaxOutput":
        if attrs.get("multi_output"):
            out["label"] = (d[0],) + d[2:]
        else:
            out["label"] = (d[0],)
    elif opname.endswith("RegressionOutput"):
        out["label"] = d
    elif opname == "LeakyReLU" and attrs.get("act_type") == "prelu":
        out["gamma"] = (d[1],)
    return out


_name_lock = threading.Lock()


class _NameManager:
    _counts = {}

    @classmethod
    def next_name(cls, hint):
        with _name_lock:
            idx = cls._counts.get(hint, 0)
            cls._counts[hint] = idx + 1
        return f"{hint}{idx}"


class _Node:
    __slots__ = ("op", "name", "inputs", "attrs", "num_outputs")

    def __init__(self, op, name, inputs, attrs, num_outputs=1):
        self.op = op              # None for variables
        self.name = name
        self.inputs = inputs      # list[Symbol]
        self.attrs = attrs        # coerced op params
        self.num_outputs = num_outputs


def _op_kwargs(node):
    return {k: v for k, v in node.attrs.items() if not k.startswith("__")}


def _call_op(op, arrays, kwargs, training, device):
    """``op.fn`` on tensors, with the generator and mode the eager
    dispatch passes (``_dispatch.invoke``)."""
    call = dict(kwargs)
    if "ctx" in call:
        call["ctx"] = device
    if op.needs_rng:
        call["generator"] = None if device.type == "meta" else \
            _random.sampler_generator(device)
    if op.needs_mode:
        call["training"] = training
    out = op.fn(*arrays, **call)
    return list(out) if isinstance(out, (tuple, list)) else [out]


class Symbol:
    """One output of a graph node (ref: symbol.py Symbol)."""

    def __init__(self, node, index=0):
        self._node = node
        self._index = index

    # -- identity ------------------------------------------------------------
    @property
    def name(self):
        n = self._node
        if n.num_outputs > 1 and n.op is not None:
            return f"{n.name}_output{self._index}"
        return n.name

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def attr(self, key):
        return self._node.attrs.get(key)

    def list_attr(self):
        return {k: str(v) for k, v in self._node.attrs.items()}

    # -- graph walks ---------------------------------------------------------
    def _topo(self):
        """Topological order of the nodes reachable from this output
        (iterative: a deep graph does not reach Python's recursion
        limit)."""
        seen = set()
        order = []
        stack = [(self._node, False)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for s in reversed(node.inputs):
                if id(s._node) not in seen:
                    stack.append((s._node, False))
        return order

    def list_arguments(self):
        """Variable names in topological order, aux excluded."""
        aux = set(self.list_auxiliary_states())
        return [node.name for node in self._topo()
                if node.op is None and node.name not in aux]

    def list_auxiliary_states(self):
        """Inputs the op mutates (BatchNorm's moving statistics), by
        input-slot position (ref: list_auxiliary_states)."""
        aux = []
        for node in self._topo():
            if node.op is None:
                continue
            names, n_aux = _OP_INPUTS.get(node.op, (None, 0))
            if n_aux:
                for s in node.inputs[len(names) - n_aux:]:
                    if s._node.op is None and s._node.name not in aux:
                        aux.append(s._node.name)
        return aux

    def _output_name(self):
        n = self._node
        if n.op is None:
            return n.name
        if n.num_outputs > 1:
            return f"{n.name}_output{self._index}"
        return f"{n.name}_output"

    def list_outputs(self):
        n = self._node
        if n.op == "_group":
            return [s._output_name() for s in n.inputs]
        return [Symbol(n, i)._output_name() for i in range(n.num_outputs)] \
            if n.op is not None else [n.name]

    def get_internals(self):
        """ref: Symbol.get_internals — every node output as a Group."""
        return Group([Symbol(node, i) for node in self._topo()
                      for i in range(node.num_outputs)])

    def __iter__(self):
        if self._node.op == "_group":
            return iter(self._node.inputs)
        return (Symbol(self._node, i)
                for i in range(self._node.num_outputs))

    def __len__(self):
        if self._node.op == "_group":
            return len(self._node.inputs)
        return self._node.num_outputs

    def __getitem__(self, index):
        if isinstance(index, str):
            for i, name in enumerate(self.list_outputs()):
                if name == index:
                    index = i
                    break
            else:
                raise MXNetError(f"no output named {index!r}")
        if self._node.op == "_group":
            return self._node.inputs[index]
        return Symbol(self._node, index)

    # -- evaluation ----------------------------------------------------------
    def _output_symbols(self):
        if self._node.op == "_group":
            return list(self._node.inputs)
        return [self]

    def _make_eval_fn(self, training=False, capture_re=None):
        """The DAG as ``fn(values: name -> tensor) -> (outputs,
        aux_updates)``. In training, BatchNorm's moving statistics come
        back in ``aux_updates`` as ``mom * old + (1 - mom) * batch``;
        ``capture_re`` (a compiled regex) adds the outputs of the matching
        op nodes (named ``<node>_output``, as the reference's Monitor
        names them) under ``__monitor__:`` keys."""
        out_syms = self._output_symbols()
        topo = self._topo()

        def run(values):
            cache = {}
            aux_updates = {}
            device = None
            for v in values.values():
                if isinstance(v, torch.Tensor):
                    device = v.device
                    break
            if device is None:
                from .._dispatch import as_device
                device = as_device(current_context())
            for node in topo:
                if node.op is None:
                    try:
                        res = [values[node.name]]
                    except KeyError:
                        raise MXNetError(f"symbol variable {node.name!r} "
                                         "was not bound") from None
                else:
                    arrays = [cache[id(s._node)][s._index]
                              for s in node.inputs]
                    if node.op == "_group":
                        res = arrays
                    elif node.op in _cflow.CONTROL_FLOW_OPS:
                        res = list(_cflow.control_flow_fn(node, training)
                                   (*arrays))
                    else:
                        res = _call_op(_registry.get(node.op), arrays,
                                       _op_kwargs(node), training, device)
                        if node.op == "BatchNorm" and training and \
                                not node.attrs.get("use_global_stats"):
                            mom = node.attrs.get("momentum", 0.9)
                            for s, stat in ((node.inputs[3], res[1]),
                                            (node.inputs[4], res[2])):
                                if s._node.op is None:
                                    old = values[s._node.name]
                                    aux_updates[s._node.name] = \
                                        mom * old + (1 - mom) * stat
                cache[id(node)] = res
                if capture_re is not None and node.op not in (None,
                                                              "_group"):
                    mon_name = f"{node.name}_output"
                    if capture_re.match(mon_name):
                        aux_updates[f"__monitor__:{mon_name}"] = res[0]
            outs = [cache[id(s._node)][s._index] for s in out_syms]
            return outs, aux_updates
        return run

    def eval(self, ctx=None, **kwargs):
        """ref: Symbol.eval — eager evaluation with named inputs; returns
        a list of NDArrays."""
        from .. import ndarray as nd
        values = {k: (v._data if isinstance(v, nd.NDArray)
                      else nd.array(v, ctx=ctx)._data)
                  for k, v in kwargs.items()}
        with torch.no_grad():
            outs, _ = self._make_eval_fn(training=False)(values)
        return [nd.NDArray(o) for o in outs]

    # -- inference -----------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """ref: Symbol.infer_shape -> (arg_shapes, out_shapes,
        aux_shapes). Each op runs on ``meta`` tensors (float32, as the
        JAX package traces); parameter shapes follow from the data
        shapes by :func:`_infer_param_shapes`; what cannot be inferred is
        None."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        shapes = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                shapes[name] = tuple(shape)
        shapes.update({k: tuple(v) for k, v in kwargs.items()
                       if v is not None})
        meta = torch.device("meta")
        memo = {}

        def var_shape(node):
            if node.name not in shapes:
                shp = node.attrs.get("__shape__")
                if not shp:
                    return None
                shapes[node.name] = tuple(shp)
            return [torch.empty(shapes[node.name], dtype=torch.float32,
                                device=meta)]

        def inputs_of(node):
            ins = []
            for s in node.inputs:
                r = shape_of(s._node)
                if r is None:
                    return None
                ins.append(r[s._index])
            return ins

        def node_shape(node):
            if node.op == "_group":
                return inputs_of(node)
            if node.op in _cflow.CONTROL_FLOW_OPS:
                ins = inputs_of(node)
                if ins is None:
                    return None
                try:
                    return list(_cflow.control_flow_fn(node, False)(*ins))
                except Exception:
                    return None
            if node.inputs:
                data_r = shape_of(node.inputs[0]._node)
                data_shape = tuple(data_r[node.inputs[0]._index].shape) \
                    if data_r is not None else None
                rules = _infer_param_shapes(node.op, node.attrs, data_shape)
                names, _ = _OP_INPUTS.get(node.op, (None, 0))
                if rules and names:
                    for slot, s in zip(names, node.inputs):
                        if s._node.op is None and \
                                s._node.name not in shapes and slot in rules:
                            shapes[s._node.name] = rules[slot]
            ins = inputs_of(node)
            if ins is None:
                return None
            try:
                with torch.no_grad():
                    return _call_op(_registry.get(node.op), ins,
                                    _op_kwargs(node), False, meta)
            except Exception:
                return None

        def shape_of(node):
            if node.op is None:      # variables re-read ``shapes``
                return var_shape(node)
            if id(node) not in memo:
                memo[id(node)] = node_shape(node)
            return memo[id(node)]

        # children before parents: no deep recursion on a long graph
        for node in self._topo():
            if node.op is not None:
                shape_of(node)
        res = shape_of(self._node)
        if res is None:
            out_shapes = None
        elif self._node.op == "_group":
            out_shapes = [tuple(r.shape) for r in res]
        else:
            out_shapes = [tuple(res[s._index].shape)
                          for s in self._output_symbols()]
        return ([shapes.get(n) for n in arg_names], out_shapes,
                [shapes.get(n) for n in aux_names])

    def infer_type(self, *args, **kwargs):
        """float32 for every argument, output and aux state, as the JAX
        package infers."""
        return ([np.float32] * len(self.list_arguments()), [np.float32],
                [np.float32] * len(self.list_auxiliary_states()))

    # -- serialization (ref: Symbol.tojson / save) ---------------------------
    def tojson(self):
        nodes = []
        index = {}
        topo = self._topo()
        for node in topo:
            index[id(node)] = len(nodes)
            entry = {
                "op": "null" if node.op is None else node.op,
                "name": node.name,
                "inputs": [[index[id(s._node)], s._index, 0]
                           for s in node.inputs],
            }
            if node.op in _cflow.CONTROL_FLOW_OPS:
                attrs = _cflow.serialize_attrs(node.attrs)
            else:
                attrs = {k: str(v) for k, v in node.attrs.items()
                         if v is not None}
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        arg_nodes = [i for i, n in enumerate(topo) if n.op is None]
        heads = [[index[id(s._node)], s._index, 0]
                 for s in self._output_symbols()]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10700]}},
                          indent=2)

    def save(self, fname):
        from ..resilience.atomic import atomic_write
        with atomic_write(fname, "w") as f:
            f.write(self.tojson())

    # -- binding (ref: simple_bind / bind -> GraphExecutor) ------------------
    def simple_bind(self, ctx=None, grad_req="write", **kwargs):
        """Allocate zero arguments and aux states of the inferred shapes
        on ``ctx`` (the current context when None) and bind them."""
        from .. import ndarray as nd
        from .executor import Executor
        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        args = {}
        for name, shape in zip(self.list_arguments(), arg_shapes):
            if shape is None:
                raise MXNetError(f"simple_bind: could not infer shape of "
                                 f"{name!r}; pass it explicitly")
            args[name] = nd.zeros(shape, ctx=ctx)
        aux = {}
        for name, shape in zip(self.list_auxiliary_states(), aux_shapes):
            if shape is None:
                raise MXNetError(f"simple_bind: could not infer shape of "
                                 f"aux {name!r}")
            aux[name] = nd.zeros(shape, ctx=ctx)
        return Executor(self, ctx, args, grad_req=grad_req, aux_states=aux)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, shared_exec=None):
        from .executor import Executor
        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        return Executor(self, ctx, args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states or {})

    # -- operators -----------------------------------------------------------
    def _binop(self, other, opname, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(opname, [a, b], {})
        scalar_op = {"elemwise_add": "_plus_scalar",
                     "elemwise_sub": "_rminus_scalar" if reverse
                     else "_minus_scalar",
                     "elemwise_mul": "_mul_scalar",
                     "elemwise_div": "_rdiv_scalar" if reverse
                     else "_div_scalar",
                     "_power": "_rpower_scalar" if reverse
                     else "_power_scalar"}[opname]
        return _create(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, other):
        return self._binop(other, "elemwise_add")
    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub")

    def __rsub__(self, other):
        return self._binop(other, "elemwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul")
    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div")

    def __rtruediv__(self, other):
        return self._binop(other, "elemwise_div", reverse=True)

    def __pow__(self, other):
        return self._binop(other, "_power")

    def __neg__(self):
        return self._binop(-1.0, "elemwise_mul")

    # comparisons build graph nodes, as NDArray's do
    def _cmpop(self, other, broadcast_name, scalar_name):
        if isinstance(other, Symbol):
            return _create(broadcast_name, [self, other], {})
        return _create(scalar_name, [self], {"scalar": float(other)})

    def __eq__(self, other):
        return self._cmpop(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._cmpop(other, "broadcast_not_equal",
                           "_not_equal_scalar")

    # __eq__ builds a node, so hashing stays by identity
    __hash__ = object.__hash__

    def __lt__(self, other):
        return self._cmpop(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._cmpop(other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __gt__(self, other):
        return self._cmpop(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._cmpop(other, "broadcast_greater_equal",
                           "_greater_equal_scalar")


def _auto_var(name, attrs=None):
    return Symbol(_Node(None, name, [], attrs or {}))


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """ref: symbol.py var / Variable."""
    from ..base import dtype_name
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if init is not None:
        attrs["__init__"] = init
    return _auto_var(name, attrs)


Variable = var


def Group(symbols):
    """ref: symbol.py Group — a multi-output symbol."""
    symbols = list(symbols)
    if not symbols:
        raise MXNetError("Group needs at least one symbol")
    node = _Node("_group", _NameManager.next_name("group"), symbols, {},
                 num_outputs=len(symbols))
    return Symbol(node)


def _create(opname, input_syms, kwargs, name=None):
    """An op node (the generated ``mx.sym.<op>`` wrappers call this): the
    name from ``mx.name``'s current scope, the attributes of
    ``mx.AttrScope``'s as ``__key__``, missing parameter variables
    created with the reference's names."""
    from .. import attribute as _attr_mod
    from .. import name as _name_mod
    op = _registry.get(opname)
    attrs = op.coerce_params(kwargs)
    hint = opname.lower().lstrip("_")
    scoped = _name_mod.current()
    if name is None and type(scoped) is not _name_mod.NameManager:
        name = scoped.get(None, hint)        # Prefix or a custom manager
    name = name or _NameManager.next_name(hint)
    for k, v in _attr_mod.current().get().items():
        attrs.setdefault(f"__{k}__" if not k.startswith("__") else k, v)
    names, _ = _OP_INPUTS.get(opname, (None, 0))
    if names is not None:
        syms = list(input_syms)
        want = list(names)
        for pkey, drop in _SUPPRESS.items():
            if attrs.get(pkey) and drop in want:
                want.remove(drop)
        if opname == "RNN" and attrs.get("mode") != "lstm" and \
                "state_cell" in want:
            want.remove("state_cell")
        if opname == "LeakyReLU" and "gamma" in want and \
                str(attrs.get("act_type", "leaky")) != "prelu":
            want.remove("gamma")     # only prelu carries a learned slope
        while len(syms) < len(want):
            syms.append(_auto_var(f"{name}_{want[len(syms)]}"))
        input_syms = syms
    return Symbol(_Node(opname, name, list(input_syms), attrs,
                        num_outputs=op.n_outputs(attrs)))


# -- creation helpers of the mx.sym namespace --------------------------------
def zeros(shape, dtype=None, **kwargs):
    return _create("_zeros", [], {"shape": shape, "dtype": dtype or "float32"})


def ones(shape, dtype=None, **kwargs):
    return _create("_ones", [], {"shape": shape, "dtype": dtype or "float32"})


def arange(start, stop=None, step=1.0, **kwargs):
    return _create("_arange", [], {"start": start, "stop": stop,
                                   "step": step})


def load_json(json_str):
    """A Symbol from its JSON (ref: sym.load_json); reads the JAX
    package's graphs and the reference's schema."""
    graph = json.loads(json_str)
    built = []
    for entry in graph["nodes"]:
        inputs = [Symbol(built[i], oi) for i, oi, _ in entry.get("inputs", [])]
        if entry["op"] == "null":
            parsed = {}
            for k, v in entry.get("attrs", {}).items():
                parsed[k] = tuple(ast.literal_eval(v)) if k == "__shape__" \
                    else v
            node = _Node(None, entry["name"], [], parsed)
        elif entry["op"] == "_group":
            node = _Node("_group", entry["name"], inputs, {},
                         num_outputs=len(inputs))
        elif entry["op"] in _cflow.CONTROL_FLOW_OPS:
            attrs = _cflow.deserialize_attrs(entry.get("attrs", {}),
                                             entry["op"])
            node = _Node(entry["op"], entry["name"], inputs, attrs,
                         num_outputs=_cflow.num_outputs_of_node(
                             entry["op"], attrs))
        else:
            op = _registry.get(entry["op"])
            raw = entry.get("attrs", {})
            attrs = op.coerce_params({k: v for k, v in raw.items()
                                      if not k.startswith("__")})
            attrs.update({k: v for k, v in raw.items() if k.startswith("__")})
            node = _Node(entry["op"], entry["name"], inputs, attrs,
                         num_outputs=op.n_outputs(attrs))
        built.append(node)
    heads = graph["heads"]
    if len(heads) == 1:
        return Symbol(built[heads[0][0]], heads[0][1])
    return Group([Symbol(built[i], oi) for i, oi, _ in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
