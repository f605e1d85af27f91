"""Symbolic control flow — subgraph nodes (counterpart of
``mxnet_tpu/symbol/control_flow.py``; ref src/operator/control_flow.cc
``_foreach`` / ``_while_loop`` / ``_cond`` and python/mxnet/symbol/
contrib.py).

A node's attrs hold its body as a sub-``Symbol``; the body's free
variables (the user's weights) become ordinary inputs of the node, so
``list_arguments`` and binding see them like any other input. Execution
takes the path ``ops.control_flow`` takes inside a program (a symbol is
always one): ``foreach`` unrolls over axis 0, ``while_loop`` runs
``max_iterations`` masked steps (a step after the predicate failed keeps
the loop variables and outputs zeros, the reference's padding) and
``cond`` evaluates both branches and selects with ``where``; no device
value is read on the host. As in the JAX package, aux-state updates
inside a body (BatchNorm's moving statistics in a loop) are dropped.
"""
from __future__ import annotations

import ast

import torch

from ..base import MXNetError

CONTROL_FLOW_OPS = {"_foreach", "_while_loop", "_cond"}

__all__ = ["foreach", "while_loop", "cond", "CONTROL_FLOW_OPS",
           "control_flow_fn"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _sym_mod():
    from . import symbol as S
    return S


def _free_variables(graph, exclude_names):
    """The variable nodes of ``graph`` not in ``exclude_names``, in
    topological order."""
    return [node for node in graph._topo()
            if node.op is None and node.name not in exclude_names]


def foreach(body, data, init_states, name=None):
    """Symbolic scan (ref: symbol/contrib.py foreach): ``body`` receives
    placeholder symbols for one slice of ``data`` and the states and
    returns (outputs, new_states) of symbols."""
    S = _sym_mod()
    name = name or S._NameManager.next_name("foreach")
    data_list = _as_list(data)
    states = _as_list(init_states)
    single_data = not isinstance(data, (list, tuple))
    single_state = not isinstance(init_states, (list, tuple))
    data_vars = [S.var(f"{name}_data{i}") for i in range(len(data_list))]
    state_vars = [S.var(f"{name}_state{i}") for i in range(len(states))]
    outs, new_states = body(data_vars[0] if single_data else data_vars,
                            state_vars[0] if single_state else state_vars)
    single_out = not isinstance(outs, (list, tuple))
    outs, new_states = _as_list(outs), _as_list(new_states)
    if len(new_states) != len(states):
        raise MXNetError(f"foreach: body returned {len(new_states)} states "
                         f"for {len(states)} init_states")
    subgraph = S.Group(outs + new_states)
    ph_names = {v.name for v in data_vars + state_vars}
    closure = _free_variables(subgraph, ph_names)
    node = S._Node("_foreach", name,
                   list(data_list) + list(states) +
                   [S.Symbol(n) for n in closure],
                   {"__subgraph__": subgraph,
                    "__data_vars__": [v.name for v in data_vars],
                    "__state_vars__": [v.name for v in state_vars],
                    "__closure_vars__": [n.name for n in closure],
                    "__num_outputs__": len(outs)},
                   num_outputs=len(outs) + len(new_states))
    out_syms = [S.Symbol(node, i) for i in range(len(outs))]
    st_syms = [S.Symbol(node, len(outs) + i) for i in range(len(new_states))]
    outs_r = out_syms[0] if (single_out and len(out_syms) == 1) else out_syms
    sts_r = st_syms[0] if (single_state and len(st_syms) == 1) else st_syms
    return outs_r, sts_r


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """Symbolic bounded while (ref: symbol/contrib.py while_loop): the
    outputs are stacked to ``max_iterations`` rows along axis 0, the rows
    past the executed steps zeros."""
    S = _sym_mod()
    if max_iterations is None:
        raise MXNetError("while_loop: max_iterations is required "
                         "(static shapes; the reference requires it too)")
    name = name or S._NameManager.next_name("while_loop")
    lvs = _as_list(loop_vars)
    single = not isinstance(loop_vars, (list, tuple))
    lv_vars = [S.var(f"{name}_loopvar{i}") for i in range(len(lvs))]
    cond_out = cond(*lv_vars)
    outs, new_lvs = func(*lv_vars)
    single_out = not isinstance(outs, (list, tuple))
    outs, new_lvs = _as_list(outs), _as_list(new_lvs)
    if len(new_lvs) != len(lvs):
        raise MXNetError(f"while_loop: func returned {len(new_lvs)} loop "
                         f"vars for {len(lvs)}")
    body_graph = S.Group(outs + new_lvs)
    closure = _free_variables(S.Group([cond_out] + outs + new_lvs),
                              {v.name for v in lv_vars})
    node = S._Node("_while_loop", name,
                   list(lvs) + [S.Symbol(n) for n in closure],
                   {"__cond_graph__": cond_out,
                    "__body_graph__": body_graph,
                    "__loop_vars__": [v.name for v in lv_vars],
                    "__closure_vars__": [n.name for n in closure],
                    "__num_outputs__": len(outs),
                    "__max_iterations__": int(max_iterations)},
                   num_outputs=len(outs) + len(new_lvs))
    out_syms = [S.Symbol(node, i) for i in range(len(outs))]
    st_syms = [S.Symbol(node, len(outs) + i) for i in range(len(new_lvs))]
    outs_r = out_syms[0] if (single_out and len(out_syms) == 1) else out_syms
    sts_r = st_syms[0] if (single and len(st_syms) == 1) else st_syms
    return outs_r, sts_r


def cond(pred, then_func, else_func, name=None):
    """Symbolic branch (ref: symbol/contrib.py cond): ``pred`` is a
    one-element Symbol; the thunks return symbols of matching shapes."""
    S = _sym_mod()
    name = name or S._NameManager.next_name("cond")
    then_out = _as_list(then_func())
    else_out = _as_list(else_func())
    if len(then_out) != len(else_out):
        raise MXNetError("cond: branches must return the same number of "
                         "outputs")
    closure = _free_variables(S.Group(then_out + else_out), set())
    node = S._Node("_cond", name,
                   [pred] + [S.Symbol(n) for n in closure],
                   {"__then_graph__": S.Group(then_out),
                    "__else_graph__": S.Group(else_out),
                    "__closure_vars__": [n.name for n in closure],
                    "__num_outputs__": len(then_out)},
                   num_outputs=len(then_out))
    outs = [S.Symbol(node, i) for i in range(len(then_out))]
    return outs[0] if len(then_out) == 1 else outs


# -- execution: shared by Symbol._make_eval_fn and infer_shape (meta) --------

def control_flow_fn(node, training):
    """``fn(*input_tensors) -> tuple(outputs)`` of a control-flow node."""
    a = node.attrs
    if node.op == "_foreach":
        sub_run = a["__subgraph__"]._make_eval_fn(training=training)
        d_names, s_names = a["__data_vars__"], a["__state_vars__"]
        c_names = a["__closure_vars__"]
        n_out = a["__num_outputs__"]

        def fn(*arrays):
            nd_, ns_ = len(d_names), len(s_names)
            datas = arrays[:nd_]
            carry = list(arrays[nd_:nd_ + ns_])
            closure = dict(zip(c_names, arrays[nd_ + ns_:]))
            steps = []
            for i in range(datas[0].shape[0]):
                vals = dict(closure)
                vals.update(zip(d_names, (d[i] for d in datas)))
                vals.update(zip(s_names, carry))
                outs, _aux = sub_run(vals)
                steps.append(outs[:n_out])
                carry = outs[n_out:]
            stacked = [torch.stack([s[j] for s in steps], 0)
                       for j in range(n_out)]
            return tuple(stacked) + tuple(carry)
        return fn

    if node.op == "_while_loop":
        cond_run = a["__cond_graph__"]._make_eval_fn(training=training)
        body_run = a["__body_graph__"]._make_eval_fn(training=training)
        lv_names, c_names = a["__loop_vars__"], a["__closure_vars__"]
        n_out = a["__num_outputs__"]
        max_it = a["__max_iterations__"]

        def fn(*arrays):
            nlv = len(lv_names)
            cur = list(arrays[:nlv])
            closure = dict(zip(c_names, arrays[nlv:]))
            done = torch.zeros((), dtype=torch.bool, device=cur[0].device)
            steps = []
            for _ in range(max_it):
                vals = dict(closure)
                vals.update(zip(lv_names, cur))
                (c,), _ = cond_run(vals)
                keep = torch.logical_and(torch.logical_not(done),
                                         c.reshape(()).to(torch.bool))
                outs, _aux = body_run(vals)
                cur = [torch.where(keep, n, o)
                       for n, o in zip(outs[n_out:], cur)]
                steps.append([torch.where(keep, o, torch.zeros_like(o))
                              for o in outs[:n_out]])
                done = torch.logical_or(done, torch.logical_not(keep))
            stacked = [torch.stack([s[j] for s in steps], 0)
                       for j in range(n_out)]
            return tuple(stacked) + tuple(cur)
        return fn

    if node.op == "_cond":
        then_run = a["__then_graph__"]._make_eval_fn(training=training)
        else_run = a["__else_graph__"]._make_eval_fn(training=training)
        c_names = a["__closure_vars__"]

        def fn(pred, *arrays):
            vals = dict(zip(c_names, arrays))
            t_outs, _ = then_run(vals)
            e_outs, _ = else_run(vals)
            p = pred.reshape(()).to(torch.bool)
            return tuple(torch.where(p, t, e) for t, e in zip(t_outs, e_outs))
        return fn

    raise MXNetError(f"not a control-flow node: {node.op}")


# -- serialization -----------------------------------------------------------

_GRAPH_KEYS = ("__subgraph__", "__cond_graph__", "__body_graph__",
               "__then_graph__", "__else_graph__")
_LIST_KEYS = ("__data_vars__", "__state_vars__", "__loop_vars__",
              "__closure_vars__")
_INT_KEYS = ("__num_outputs__", "__max_iterations__")


def serialize_attrs(attrs):
    """attrs as JSON strings (``Symbol.tojson``): a body as its JSON."""
    return {k: v.tojson() if k in _GRAPH_KEYS else str(v)
            for k, v in attrs.items()}


def deserialize_attrs(raw, op):
    """The live attrs of a loaded node."""
    from . import symbol as S
    attrs = {}
    for k, v in raw.items():
        if k in _GRAPH_KEYS:
            attrs[k] = S.load_json(v)
        elif k in _LIST_KEYS:
            attrs[k] = list(ast.literal_eval(v))
        elif k in _INT_KEYS:
            attrs[k] = int(v)
        else:
            attrs[k] = v
    return attrs


def num_outputs_of_node(op, attrs):
    if op == "_foreach":
        return attrs["__num_outputs__"] + len(attrs["__state_vars__"])
    if op == "_while_loop":
        return attrs["__num_outputs__"] + len(attrs["__loop_vars__"])
    return attrs["__num_outputs__"]
