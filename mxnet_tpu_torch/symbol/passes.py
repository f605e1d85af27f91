"""Graph passes (counterpart of ``mxnet_tpu/symbol/passes.py``; ref
nnvm::ApplyPass and the subgraph backends of src/operator/subgraph/,
selected with ``MXNET_SUBGRAPH_BACKEND``).

Passes rewrite the Symbol DAG before bind. ``CSE`` merges structurally
equal nodes; ``FuseAttention`` rewrites full attention to
``_contrib_flash_attention``, which is the flash-attention kernel (K3)
on the card above 1024 keys. ``MXNET_SUBGRAPH_BACKEND=<name>[,<name>]``
applies registered passes at bind time, as the reference's subgraph
backends are activated.
"""
from __future__ import annotations

import os
import warnings

from ..base import MXNetError
from ..ops import registry as _registry
from .symbol import Symbol, _Node

__all__ = ["register_pass", "apply_pass", "apply_env_passes", "list_passes"]

_PASSES = {}


def register_pass(name):
    """Decorator: register ``fn(Symbol) -> Symbol`` as pass ``name``."""
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def list_passes():
    return sorted(_PASSES)


def apply_pass(sym: Symbol, name: str) -> Symbol:
    """ref: nnvm::ApplyPass."""
    if name not in _PASSES:
        raise MXNetError(f"unknown graph pass {name!r}; "
                         f"known: {list_passes()}")
    return _PASSES[name](sym)


def apply_env_passes(sym: Symbol) -> Symbol:
    """The passes ``MXNET_SUBGRAPH_BACKEND`` names (a comma list), applied
    in order; an unknown name warns and is skipped, as the reference is
    lenient."""
    backends = os.environ.get("MXNET_SUBGRAPH_BACKEND", "")
    for name in filter(None, (b.strip() for b in backends.split(","))):
        if name in _PASSES:
            sym = _PASSES[name](sym)
        else:
            warnings.warn(f"MXNET_SUBGRAPH_BACKEND: unknown pass {name!r} "
                          f"ignored (known: {list_passes()})")
    return sym


def _rebuild(sym, make):
    """A copy of ``sym``'s DAG, children first: ``make(node, new_inputs,
    new_of)`` returns the new node of each old one; ``new_of(symbol)`` is
    an already rebuilt symbol's copy."""
    rebuilt = {}

    def new_of(s):
        return Symbol(rebuilt[id(s._node)], s._index)
    for node in sym._topo():
        rebuilt[id(node)] = make(node, [new_of(s) for s in node.inputs],
                                 new_of)
    return new_of(sym)


def _copy(node, new_inputs):
    return _Node(node.op, node.name, new_inputs, dict(node.attrs),
                 num_outputs=node.num_outputs)


@register_pass("CSE")
def common_subexpression_elimination(sym: Symbol) -> Symbol:
    """Merge structurally equal nodes (same op, attrs and inputs) so a
    subgraph built twice runs once. Variables unify by name; random ops
    never merge (each node is its own draw)."""
    canon = {}

    def mergeable(node):
        if node.op is None or node.op == "_group":
            return False
        try:
            op = _registry.get(node.op)
        except MXNetError:
            return False
        return not op.needs_rng

    def make(node, new_inputs, new_of):
        if node.op is None:
            sig = ("var", node.name)
        elif mergeable(node):
            sig = (node.op,
                   tuple(sorted((k, str(v)) for k, v in node.attrs.items())),
                   tuple((id(s._node), s._index) for s in new_inputs))
        else:
            sig = ("unique", id(node))
        if sig not in canon:
            canon[sig] = _copy(node, new_inputs)
        return canon[sig]

    return _rebuild(sym, make)


def _is_softmax_lastdim(node):
    # a temperature or a length changes the math: such softmaxes stay
    return node.op in ("softmax", "Softmax") and \
        int(node.attrs.get("axis", -1)) == -1 and \
        not node.attrs.get("temperature") and \
        node.attrs.get("length") is None


def _match_dot_softmax_dot(node):
    """``batch_dot(softmax(batch_dot(q, k, transpose_b) [* or / s]), v)``
    -> (q, k, v, scale), else None."""
    if node.op != "batch_dot" or node.attrs.get("transpose_a") or \
            node.attrs.get("transpose_b"):
        return None
    att, v = node.inputs
    if not _is_softmax_lastdim(att._node):
        return None
    scores = att._node.inputs[0]._node
    scale = 1.0
    if scores.op == "_mul_scalar":
        scale = float(scores.attrs.get("scalar", 1.0))
        scores = scores.inputs[0]._node
    elif scores.op == "_div_scalar":
        scale = 1.0 / float(scores.attrs.get("scalar", 1.0))
        scores = scores.inputs[0]._node
    if scores.op != "batch_dot" or scores.attrs.get("transpose_a") or \
            not scores.attrs.get("transpose_b"):
        return None
    q, k = scores.inputs
    return q, k, v, scale


def _match_interleaved(node):
    """``valatt(qkv, softmax(qk(qkv)))`` -> (qkv, heads), else None."""
    if node.op != "_contrib_interleaved_matmul_selfatt_valatt":
        return None
    qkv, att = node.inputs
    if not _is_softmax_lastdim(att._node):
        return None
    qk = att._node.inputs[0]._node
    if qk.op != "_contrib_interleaved_matmul_selfatt_qk" or \
            qk.inputs[0]._node is not qkv._node:
        return None
    return qkv, int(qk.attrs["heads"])


@register_pass("FuseAttention")
def fuse_attention(sym: Symbol) -> Symbol:
    """Rewrite full attention to ``_contrib_flash_attention`` (the
    flash-attention kernel on the card above 1024 keys). Two patterns:

    1. ``batch_dot(softmax(batch_dot(q, k, transpose_b=True) [*/ s],
       axis=-1), v)`` -> ``_contrib_flash_attention(q, k, v,
       sm_scale=s)``: the graph's scale (1.0 without one) passes through
       verbatim, so the rewrite is exact for any scale.
    2. ``_contrib_interleaved_matmul_selfatt_valatt(qkv, softmax(
       _contrib_interleaved_matmul_selfatt_qk(qkv, heads)))`` -> reshape
       and transpose to (N, H, T, D), the flash operator, and the
       inverse back to (T, N, E).
    """
    from .symbol import _create

    def make(node, new_inputs, new_of):
        if node.op is None:
            return _copy(node, new_inputs)
        m1 = _match_dot_softmax_dot(node)
        if m1 is not None:
            q, k, v, scale = m1
            return _create("_contrib_flash_attention",
                           [new_of(s) for s in (q, k, v)],
                           {"sm_scale": scale},
                           name=node.name + "_flash")._node
        m2 = _match_interleaved(node)
        if m2 is not None:
            qkv, h = m2
            qkvn = new_of(qkv)
            # (T, N, 3E) is (T, N, H, 3, D) per head, as the qk op reads it
            r1 = _create("reshape", [qkvn], {"shape": (0, 0, -4, h, -1)},
                         name=node.name + "_qh")
            r2 = _create("reshape", [r1], {"shape": (0, 0, 0, -4, 3, -1)},
                         name=node.name + "_q3")
            parts = []
            for i, nm in enumerate(("q", "k", "v")):
                sl = _create("slice_axis", [r2],
                             {"axis": 3, "begin": i, "end": i + 1},
                             name=f"{node.name}_{nm}sl")
                sq = _create("reshape", [sl], {"shape": (0, 0, 0, -1)},
                             name=f"{node.name}_{nm}sq")
                parts.append(_create("transpose", [sq],
                                     {"axes": (1, 2, 0, 3)},
                                     name=f"{node.name}_{nm}t"))
            fa = _create("_contrib_flash_attention", parts, {},
                         name=node.name + "_flash")
            back = _create("transpose", [fa], {"axes": (2, 0, 1, 3)},
                           name=node.name + "_bt")
            return _create("reshape", [back], {"shape": (0, 0, -3)},
                           name=node.name + "_merge")._node
        return _copy(node, new_inputs)

    return _rebuild(sym, make)
