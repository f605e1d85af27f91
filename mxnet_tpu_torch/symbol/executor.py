"""Executor — the bound form of a Symbol (counterpart of
``mxnet_tpu/symbol/executor.py``; ref src/executor/graph_executor.cc).

The DAG runs as a ``torch.nn.Module`` (:class:`GraphProgram`) under
autograd: its inputs are the bound arguments in ``list_arguments``
order, its buffers the aux states, which a training forward updates in
place as the JAX DAG does (``mom * old + (1 - mom) * batch`` for
BatchNorm's moving statistics). Where the JAX package compiles one
program per mode, the executor runs the module through a
``gluon.cached_graph.GraphCache``: on the card each (mode, recording,
input signature) is captured once as CUDA graphs, the forward and, in
training, the backward of its outputs, and replayed at every later call,
as a hybridized block is; on the CPU, which a caller asks for, it runs
eagerly. ``backward`` takes the gradients of the arguments whose
``grad_req`` is "write" or "add" through ``torch.autograd.grad``.
"""
from __future__ import annotations

import torch

from .. import autograd as _autograd
from ..base import MXNetError
from ..context import current_context
from ..gluon.block import HybridBlock
from ..gluon.cached_graph import CudaGraphs, GraphCache

__all__ = ["Executor", "GraphProgram"]


class GraphProgram(HybridBlock):
    """A symbol's DAG as a block: ``forward(*args)`` over the argument
    tensors in ``list_arguments`` order; the aux tensors are buffers
    (``aux0``, ``aux1``, … in ``list_auxiliary_states`` order), written
    in place by a training forward. ``capture`` (a regex string or None)
    appends the outputs of the matching op nodes, the Monitor's
    ``<node>_output`` names, after the symbol's outputs."""

    def __init__(self, symbol, aux):
        super().__init__()
        self._symbol = symbol
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        for i, name in enumerate(self._aux_names):
            self.register_buffer(f"aux{i}", aux[name])
        self._runs = {}
        self.monitored = []      # names of the appended outputs, last call

    def _run(self, training, capture):
        key = (training, capture)
        if key not in self._runs:
            import re
            self._runs[key] = self._symbol._make_eval_fn(
                training=training,
                capture_re=None if capture is None else re.compile(capture))
        return self._runs[key]

    def forward(self, *args, capture=None):
        values = dict(zip(self._arg_names, args))
        aux = {name: getattr(self, f"aux{i}")
               for i, name in enumerate(self._aux_names)}
        values.update(aux)
        outs, updates = self._run(bool(self.training), capture)(values)
        monitored = []
        with torch.no_grad():
            for name, val in updates.items():
                if name.startswith("__monitor__:"):
                    monitored.append((name[len("__monitor__:"):], val))
                else:
                    aux[name].copy_(val)
        self.monitored = [n for n, _ in monitored]
        return tuple(outs) + tuple(v for _, v in monitored)


class Executor:
    """ref: Executor — ``forward(is_train, **inputs)``, ``backward(
    out_grads)``, ``arg_dict`` / ``grad_dict`` / ``aux_dict`` and their
    ``*_arrays`` lists, ``copy_params_from``, ``install_monitor``. The
    symbol goes through the ``MXNET_SUBGRAPH_BACKEND`` passes first."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None):
        from .. import ndarray as nd
        from .passes import apply_env_passes
        symbol = apply_env_passes(symbol)
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self.arg_dict = dict(args)
        self.aux_dict = dict(aux_states or {})
        arg_names = self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(arg_names, grad_req))
        self._grad_req = grad_req
        if args_grad is None:
            args_grad = {n: nd.zeros(self.arg_dict[n].shape, ctx=self._ctx,
                                     dtype=self.arg_dict[n].dtype)
                         for n in arg_names
                         if grad_req.get(n, "null") != "null"
                         and n in self.arg_dict}
        self.grad_dict = dict(args_grad)
        missing = [n for n in self._aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError(f"bind: aux states {missing} not given")
        self._program = GraphProgram(
            symbol, {k: v._data for k, v in self.aux_dict.items()})
        self._graphs = GraphCache(CudaGraphs())
        self.outputs = []
        self._pending = None       # (outputs, leaves, names) for backward
        self._monitor = None

    def install_monitor(self, monitor):
        """ref: Executor SetMonitorCallback through mx.monitor.Monitor:
        the intermediates its pattern matches come back as extra
        outputs of the program and go to ``monitor._collect``."""
        self._monitor = monitor

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    def forward(self, is_train=False, **kwargs):
        """ref: Executor::Forward — the named inputs are copied into the
        bound arguments first. Returns ``outputs`` (NDArrays)."""
        from .. import ndarray as nd
        with torch.no_grad():
            for k, v in kwargs.items():
                if k not in self.arg_dict:
                    raise MXNetError(f"executor has no argument {k!r}")
                src = v._data if isinstance(v, nd.NDArray) else \
                    nd.array(v, ctx=self._ctx)._data
                self.arg_dict[k]._data.copy_(src)
        self._sync_aux()
        names = self._arg_names
        grad_names = [n for n in names
                      if self._grad_req.get(n, "null") != "null"]
        record = bool(is_train and grad_names)
        unbound = [n for n in names if n not in self.arg_dict]
        if unbound:
            raise MXNetError(f"symbol variables {unbound} were not bound")
        tensors = [self.arg_dict[n]._data for n in names]
        if record:
            tensors = [t.detach().requires_grad_(True) if n in grad_names
                       else t for n, t in zip(names, tensors)]
        capture = (self._monitor._pattern_re.pattern
                   if self._monitor is not None and self._monitor.activated
                   else None)
        kwargs = {} if capture is None else {"capture": capture}
        if record:
            scope = _autograd.record(train_mode=True)
        elif is_train:
            scope = _autograd.train_mode()
        else:
            scope = _autograd.predict_mode()
        with scope, torch.set_grad_enabled(record):
            outs = list(self._graphs.call(self._program, tuple(tensors),
                                          kwargs))
        n_mon = len(self._program.monitored) if capture is not None else 0
        if n_mon:
            for name, val in zip(self._program.monitored, outs[-n_mon:]):
                self._monitor._collect(name, val)
            outs = outs[:-n_mon]
        self._pending = (outs, [t for n, t in zip(names, tensors)
                                if n in grad_names], grad_names) \
            if record else None
        self.outputs = [nd.NDArray(o.detach()) for o in outs]
        return self.outputs

    def _sync_aux(self):
        """An aux NDArray rebound to another tensor (``aux_dict[k] =``,
        BucketingModule's sharing) becomes the program's buffer."""
        for i, name in enumerate(self._aux_names):
            t = self.aux_dict[name]._data
            if getattr(self._program, f"aux{i}") is not t:
                setattr(self._program, f"aux{i}", t)

    def backward(self, out_grads=None):
        """ref: Executor::Backward — the gradients into ``grad_dict`` per
        ``grad_req`` ("write" replaces, "add" accumulates). Without
        ``out_grads`` the head gradients are ones."""
        from .. import ndarray as nd
        if self._pending is None:
            raise MXNetError("backward() requires forward(is_train=True)")
        outs, leaves, grad_names = self._pending
        self._pending = None
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cts = [g._data if isinstance(g, nd.NDArray) else
                   torch.as_tensor(g, device=o.device)
                   for g, o in zip(out_grads, outs)]
        pairs = [(o, g) for o, g in zip(outs, cts) if o.requires_grad]
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        else:
            grads = [None] * len(leaves)
        with torch.no_grad():
            for name, leaf, g in zip(grad_names, leaves, grads):
                if g is None:
                    g = torch.zeros_like(leaf)
                if name not in self.grad_dict:
                    self.grad_dict[name] = nd.zeros(
                        leaf.shape, ctx=self._ctx, dtype=leaf.dtype)
                dst = self.grad_dict[name]._data
                if self._grad_req.get(name, "write") == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """ref: Executor::CopyParamsFrom — copies into the bound arrays
        (their storage stays: a captured graph keeps reading it)."""
        for table, src, what in ((self.arg_dict, arg_params, "argument"),
                                 (self.aux_dict, aux_params, "aux state")):
            for k, v in (src or {}).items():
                if k in table:
                    _copy_into(table[k], v)
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {k!r}")


def _copy_into(dst, value):
    """Copy an NDArray, tensor or array-like into NDArray ``dst`` in
    place, in ``dst``'s dtype."""
    import numpy as np

    from .. import ndarray as nd
    if isinstance(value, nd.NDArray):
        value = value._data
    elif not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    with torch.no_grad():
        dst._data.copy_(value.to(device=dst._data.device,
                                 dtype=dst._data.dtype))
