"""``mx.viz`` — network visualization (counterpart of
``mxnet_tpu/visualization.py``; ref python/mxnet/visualization.py).

``print_summary`` walks the Symbol DAG and prints the reference's layer
table (name, shape, params, connections); ``plot_network`` builds
graphviz DOT source as text (``.source``); rendering raises.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """ref: visualization.py print_summary."""
    arg_shapes = {}
    if shape is not None:
        arg_names = symbol.list_arguments()
        shapes, _, aux = symbol.infer_shape(**shape)
        arg_shapes = dict(zip(arg_names, shapes))
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    positions = [int(line_length * p) for p in positions]
    headers = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields):
        line = ""
        for f, pos in zip(fields, positions):
            line = (line + str(f))[:pos - 1].ljust(pos)
        print(line)

    print("=" * line_length)
    print_row(headers)
    print("=" * line_length)
    total = 0
    topo = symbol._topo()
    for node in topo:
        if node.op is None:
            continue
        inputs = [s._node.name for s in node.inputs]
        params = 0
        for s in node.inputs:
            if s._node.op is None and s._node.name in arg_shapes and \
                    arg_shapes[s._node.name] is not None and \
                    not s._node.name.endswith(("data", "label")):
                params += int(np.prod(arg_shapes[s._node.name]))
        total += params
        print_row([f"{node.name} ({node.op})", "", params,
                   ", ".join(inputs[:2])])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("=" * line_length)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """ref: visualization.py plot_network → graphviz Digraph source."""
    lines = [f'digraph "{title}" {{', "  rankdir=BT;"]
    topo = symbol._topo()
    idx = {}
    for i, node in enumerate(topo):
        idx[id(node)] = i
        if node.op is None:
            if hide_weights and not node.name.endswith(("data", "label")):
                continue
            lines.append(f'  n{i} [label="{node.name}" shape=oval];')
        else:
            lines.append(f'  n{i} [label="{node.name}\\n{node.op}" '
                         f'shape=box];')
    drawn = {i for i, node in enumerate(topo)
             if node.op is not None or not hide_weights
             or node.name.endswith(("data", "label"))}
    for node in topo:
        if node.op is None:
            continue
        for s in node.inputs:
            j = idx[id(s._node)]
            if j in drawn:
                lines.append(f"  n{j} -> n{idx[id(node)]};")
    lines.append("}")
    source = "\n".join(lines)

    class _Dot:
        def __init__(self, src):
            self.source = src

        def render(self, filename=None, **kwargs):
            raise MXNetError("graphviz rendering is not available in this "
                             "environment; use .source for the dot text")

        def _repr_svg_(self):
            return None
    return _Dot(source)
