"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A Block is a ``torch.nn.Module`` whose ``forward(x)`` calls the port's
plain operator functions on tensors. Children and parameters keep the
JAX package's *structural* names (``features.4.0.body.1.gamma``, see
``Block._structural_names`` there), so ``state_dict()`` keys equal the
JAX checkpoint keys. A block's mode (``Block.training``) is that of the
innermost ``autograd`` scope: training inside ``autograd.record()`` or
``train_mode()``, predict inside ``record(train_mode=False)``, ``pause()``
or ``predict_mode()``. Outside every scope a block keeps its own mode:
predict, as Gluon runs outside ``autograd.record``, unless ``.train()``
switched it.

``HybridBlock.hybridize()`` is the reference's CachedOp: on the card a
hybridized block runs each call as CUDA graphs, one program per (mode,
recording, input shapes and dtypes, device), captured at the first call
of its key (:mod:`.cached_graph`); blocks nested in it run inside its
graphs. On the CPU, which a caller asks for explicitly, it runs eagerly.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy

from .. import autograd as _autograd
from .. import initializer as _init_mod
from .. import ndarray as nd
from ..base import MXNetError, as_torch_dtype
from ..context import resolve_device
from .cached_graph import (CudaGraphs, GraphCache, in_capture,
                           structure_changed)
from .parameter import DeferredParams

__all__ = ["Block", "HybridBlock", "ParameterDict", "SymbolBlock"]


class ParameterDict(OrderedDict):
    """Structural name → parameter or buffer, as ``collect_params``
    returns it (ref: gluon.ParameterDict)."""

    def setattr(self, name, value):
        """Set attribute ``name`` of every tensor in the dict (ref:
        ParameterDict.setattr), e.g. ``net.collect_params(".*bias")
        .setattr("wd_mult", 0.0)``. ``gluon.Trainer`` hands the tensors
        to its optimizer as ``param_dict``, so ``lr_mult`` and
        ``wd_mult`` reach its update; ``parallel.ShardedTrainer`` does
        not read them, as in the reference: give its optimizer
        ``param_dict`` or ``set_wd_mult`` by trainable index there."""
        for t in self.values():
            setattr(t, name, value)


def _has_ndarray(values):
    for v in values:
        if isinstance(v, nd.NDArray) or (isinstance(v, (tuple, list))
                                         and _has_ndarray(v)):
            return True
    return False


def _unwrap(v):
    """NDArrays (also inside tuples and lists) as their tensors."""
    if isinstance(v, nd.NDArray):
        return v._data
    if isinstance(v, (tuple, list)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    """Tensors (also inside tuples and lists) as NDArrays."""
    if isinstance(v, torch.Tensor):
        return nd.NDArray(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_wrap(x) for x in v)
    return v


class Block(nn.Module):
    """Base class of all layers and models (ref: gluon/block.py Block).

    Called with NDArrays (``mx.nd``), a block unwraps them (also inside
    tuples and lists) to their tensors, runs with recording as
    ``autograd.is_recording()`` says, and wraps its tensor outputs as
    NDArrays; called with tensors it runs and returns tensors as ever.
    NDArrays that ``forward`` returns (an ``mx.nd`` sampler's) come back
    as tensors to a tensor caller and to a graph capture."""

    def __init__(self):
        super().__init__()
        self.training = False          # Gluon's default: predict mode

    def __call__(self, *args, **kwargs):
        if _has_ndarray(args) or _has_ndarray(kwargs.values()):
            args = _unwrap(args)
            kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
            with torch.set_grad_enabled(_autograd.is_recording()):
                return _wrap(self._call(*args, **kwargs))
        out = self._call(*args, **kwargs)
        return out if isinstance(out, torch.Tensor) else _unwrap(out)

    def _call(self, *args, **kwargs):
        return super().__call__(*args, **kwargs)

    @property
    def training(self):
        """Training mode: the innermost ``autograd`` scope's, else the
        block's own (``.train()`` / ``.eval()``)."""
        mode = _autograd.scope_training()
        return self.__dict__.get("_own_training", False) if mode is None \
            else mode

    @training.setter
    def training(self, value):
        self.__dict__["_own_training"] = bool(value)

    # a captured graph reads tensors by address: a program lists its
    # block's tensors anew after any of these
    def __setattr__(self, name, value):
        if isinstance(value, nn.Module):
            structure_changed()
        super().__setattr__(name, value)

    def add_module(self, name, module):
        structure_changed()
        super().add_module(name, module)

    def register_parameter(self, name, param):
        structure_changed()
        super().register_parameter(name, param)

    def register_buffer(self, name, tensor, persistent=True):
        structure_changed()
        super().register_buffer(name, tensor, persistent)

    def initialize(self, init=None, ctx=None, generator=None,
                   force_reinit=False):
        """Materialize and fill every parameter whose shape is known on
        ``ctx`` (default ``cuda:0``; raises without CUDA unless
        ``ctx=cpu()``), drawing from ``generator`` (PyTorch's default
        generator when None). Parameters with a shape still to infer
        materialize at the first forward with the same plan. ``init``
        defaults to ``Uniform(0.07)`` as in the reference; a layer's own
        initializer (e.g. BatchNorm gamma "ones") takes precedence."""
        device = resolve_device(ctx)
        init = _init_mod.create(init if init is not None
                                else _init_mod.Uniform())
        for module in self.modules():
            if isinstance(module, DeferredParams):
                module._init_params(init, device, generator, force_reinit)
        self._clear_cached_op()
        return self

    def collect_params(self, select=None) -> ParameterDict:
        """Structural name → parameter or buffer of this block and its
        descendants (ref: Block.collect_params; keys as
        ``_structural_names``). ``select`` is a regex on the name."""
        pattern = None if select is None else re.compile(select)
        return ParameterDict(
            (k, v) for k, v in self.state_dict(keep_vars=True).items()
            if pattern is None or pattern.match(k))

    # -- checkpointing (ref: Block.save_parameters / load_parameters) --------
    def load_dict(self, arrays, ctx=None, allow_missing=False,
                  ignore_extra=False, source="<param dict>"):
        """Load ``{structural name: array}`` (tensors or numpy arrays);
        missing keys, extra keys and shape mismatches raise unless
        allowed. ``arg:``/``aux:`` prefixes (a trainer checkpoint's) are
        stripped, as in the reference. Uninitialized parameters
        materialize from the loaded shapes on the device ``initialize``
        chose, else on ``ctx`` (default ``cuda:0``)."""
        arrays = {k.partition(":")[2] if k.partition(":")[0] in
                  ("arg", "aux") and ":" in k else k: v
                  for k, v in arrays.items()}
        params = self.collect_params()
        missing = [k for k in params if k not in arrays]
        if missing and not allow_missing:
            raise MXNetError(f"parameters {missing} missing from {source}")
        extra = sorted(set(arrays) - set(params))
        if extra and not ignore_extra:
            raise MXNetError(f"{source} has extra parameters {extra}; pass "
                             "ignore_extra=True")
        device, rebound = None, False
        for key, cur in params.items():
            if key not in arrays:
                continue
            shape = tuple(np.shape(arrays[key]))
            if not is_lazy(cur) and tuple(cur.shape) != shape:
                raise MXNetError(f"parameter {key} is {shape} in {source}, "
                                 f"{tuple(cur.shape)} in the block")
        for module in self.modules():
            if not isinstance(module, DeferredParams) \
                    or module._init_plan is not None:
                continue                 # initialize() chose the device
            for name, spec in module._specs.items():
                if is_lazy(module._tensor(name)):
                    if device is None:
                        device = resolve_device(ctx)
                    module._reset_lazy(name, spec, device)
                    rebound = True
        state = {k: v if isinstance(v, torch.Tensor)
                 else torch.tensor(np.asarray(v))
                 for k, v in arrays.items() if k in params}
        self.load_state_dict(state, strict=False)   # in place where live
        if rebound:
            self._clear_cached_op()
        return self

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter and buffer to ``filename`` as the
        ``.params`` container keyed by structural name (``nd.save``), the
        file the JAX package's ``save_parameters`` writes and its
        ``load_parameters`` reads."""
        nd.save(filename, dict(self.collect_params()))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load a ``.params`` file of either package (``nd.load``) through
        :meth:`load_dict`."""
        loaded = nd._load_tensors(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} is not a parameter dict file")
        return self.load_dict(loaded, ctx=ctx, allow_missing=allow_missing,
                              ignore_extra=ignore_extra, source=filename)

    def cast(self, dtype):
        """Cast every floating parameter and buffer of this block and its
        descendants to ``dtype`` (ref: Block.cast), and reset each
        parameter's gradient to zeros of the new dtype, as the reference
        re-creates the gradient buffer. Parameters still to infer take
        ``dtype`` when they materialize. Drops the captured graphs."""
        dtype = as_torch_dtype(dtype)
        for module in self.modules():
            for spec in getattr(module, "_specs", {}).values():
                if spec.dtype.is_floating_point:
                    spec.dtype = dtype
        with torch.no_grad():
            for t in self.state_dict(keep_vars=True).values():
                if t.is_floating_point():
                    t.data = t.data.to(dtype)
                    if t.grad is not None:
                        t.grad = torch.zeros_like(t)
        self._clear_cached_op()
        return self

    def hybridize(self, active=True, **kwargs):
        """Nothing on a plain Block; recurses so that nested HybridBlocks
        engage (ref: Block.hybridize)."""
        for child in self.children():
            child.hybridize(active, **kwargs)

    def _clear_cached_op(self):
        """Drop the captured graphs of this block and its descendants
        (ref: HybridBlock._clear_cached_op): after ``initialize`` and
        after a load that rebound a deferred parameter's storage."""
        for module in self.modules():
            graphs = module.__dict__.get("_graphs")
            if graphs is not None:
                graphs.clear()


class HybridBlock(Block):
    """A Block that runs as one compiled program per input signature once
    hybridized (ref: gluon/block.py HybridBlock; CachedOp ≡ CUDA graphs
    here, see :mod:`.cached_graph`)."""

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None):
        """Capture this block's calls on the card as CUDA graphs
        (``active``), or stop (``active=False``). Every call drops the
        graphs captured so far and frees their pools, then recurses into
        the children. The other arguments are the reference's and change
        nothing: a graph is always statically allocated."""
        self._clear_cached_op()
        self.__dict__["_graphs"] = GraphCache(CudaGraphs()) if active \
            else None
        for child in self.children():
            child.hybridize(active, static_alloc=static_alloc,
                            static_shape=static_shape)

    def _call(self, *args, **kwargs):
        """ref: HybridBlock.__call__ — the cached program when hybridized
        and no outer program is being captured on this thread, else the
        eager forward."""
        if not in_capture():
            # the input signature ``export`` traces with
            self.__dict__["_last_inputs"] = [
                (tuple(a.shape), a.dtype) for a in args
                if isinstance(a, torch.Tensor)]
        graphs = self.__dict__.get("_graphs")
        if graphs is None or in_capture():
            return nn.Module.__call__(self, *args, **kwargs)
        return graphs.call(self, args, kwargs)

    # -- deployment (ref: HybridBlock.export -> -symbol.json + .params) ------
    def export(self, path, epoch=0, remove_amp_cast=True, input_specs=None):
        """Write ``path-symbol.json`` (the block's predict-mode graph,
        loadable by ``SymbolBlock.imports`` and ``mx.sym.load`` of either
        package) and ``path-%04d.params`` (``nd.save``, ``arg:`` and
        ``aux:`` keys by ``collect_params()`` name, ``aux:`` for the
        graph's auxiliary states). The graph is traced on meta tensors
        (:mod:`.export`) of the shapes and dtypes of the block's last
        call, as MXNet exports after a forward, or of ``input_specs``
        ([(shape, dtype)]). Returns the two file names."""
        from .export import trace
        specs = input_specs or self.__dict__.get("_last_inputs")
        if not specs:
            raise MXNetError("export: run a forward with this block (or "
                             "pass input_specs=) before export")
        specs = [(tuple(s), as_torch_dtype(d)) for s, d in specs]
        names = ["data"] if len(specs) == 1 else \
            [f"data{i}" for i in range(len(specs))]
        sym = trace(self, specs, names)
        sym.save(f"{path}-symbol.json")
        aux = set(sym.list_auxiliary_states())
        params = {("aux:" if name in aux else "arg:") + name: t
                  for name, t in self.collect_params().items()}
        nd.save(f"{path}-{epoch:04d}.params", params)
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"


class _ParamNode(Block):
    """A container on the path of a dotted parameter name, so that a
    SymbolBlock's ``collect_params()`` keys are its variables' names."""


class SymbolBlock(HybridBlock):
    """A loaded Symbol graph as a Gluon block (ref: gluon SymbolBlock;
    counterpart of ``mxnet_tpu/gluon/block.py:556-588``): the deployment
    path of ``export`` and ``model.save_checkpoint`` files. Its
    parameters are the graph's variables but the inputs, keyed by the
    variable names (``features.0.weight`` lives at that structural path);
    the aux states (BatchNorm's moving statistics) are buffers. ``forward``
    runs the graph in predict mode, as the JAX SymbolBlock does;
    ``hybridize()`` runs it as CUDA graphs on the card. Without
    ``params`` the parameters materialize at the first forward from the
    inputs' shapes (``infer_shape``), filled by the initializer that
    ``initialize`` recorded."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__()
        from .. import symbol as sym_mod
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._outputs = outputs
        self._inputs = list(inputs)
        input_names = {s.name for s in self._inputs}
        self._aux_names = [n for n in outputs.list_auxiliary_states()
                           if n not in input_names]
        self._param_names = [n for n in outputs.list_arguments()
                             if n not in input_names] + self._aux_names
        self._slots = []
        self._plan = None
        if params is not None:
            self._set_params(params)

    def _set_params(self, params, device=None):
        """Register ``params`` (name -> tensor, NDArray or array) at their
        structural paths."""
        missing = [n for n in self._param_names if n not in params]
        if missing:
            raise MXNetError(f"SymbolBlock: parameters {missing[:5]} "
                             "missing")
        aux = set(self._aux_names)
        slots = []
        for name in self._param_names:
            value = params[name]
            if isinstance(value, nd.NDArray):
                value = value._data
            elif not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value))
            if device is not None:
                value = value.to(device)
            *path, leaf = name.split(".")
            node = self
            for part in path:
                child = node._modules.get(part)
                if child is None:
                    child = _ParamNode()
                    node.add_module(part, child)
                node = child
            value = value.detach()
            if name in aux:
                node.register_buffer(leaf, value)
            else:
                node.register_parameter(
                    leaf, nn.Parameter(value, requires_grad=True))
            slots.append((name, node, leaf))
        self._slots = slots
        self._clear_cached_op()

    def initialize(self, init=None, ctx=None, generator=None,
                   force_reinit=False):
        """Record how the first forward fills parameters that were not
        given (ref: Block.initialize); loaded ones are kept unless
        ``force_reinit``."""
        self._plan = (_init_mod.create(init if init is not None
                                       else _init_mod.Uniform()),
                      resolve_device(ctx), generator)
        if force_reinit and self._slots:
            with torch.no_grad():
                for name, node, leaf in self._slots:
                    self._plan[0](name, getattr(node, leaf), generator)
        return self

    def _materialize(self, args):
        if self._plan is None:
            raise MXNetError("SymbolBlock: no parameters; load them "
                             "(imports with a param file) or call "
                             "initialize() first")
        init, device, generator = self._plan
        shapes = {s.name: tuple(a.shape) for s, a in zip(self._inputs, args)}
        arg_shapes, _, aux_shapes = self._outputs.infer_shape(**shapes)
        known = dict(zip(self._outputs.list_arguments(), arg_shapes))
        known.update(zip(self._outputs.list_auxiliary_states(), aux_shapes))
        params = {}
        for name in self._param_names:
            if known.get(name) is None:
                raise MXNetError(f"SymbolBlock: cannot infer the shape of "
                                 f"{name!r} from the inputs")
            t = torch.empty(known[name], dtype=torch.float32, device=device)
            init(name, t, generator)
            params[name] = t
        self._set_params(params)

    def forward(self, *args):
        from .. import symbol as sym_mod
        if not self._slots and self._param_names:
            self._materialize(args)
        params = {name: getattr(node, leaf)
                  for name, node, leaf in self._slots}
        return sym_mod.eval_symbol(self._outputs, self._inputs, args, params)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """ref: SymbolBlock.imports — a block of the graph in
        ``symbol_file`` with ``input_names`` as its inputs and, when
        ``param_file`` is given, its parameters loaded onto ``ctx``
        (``cuda:0`` unless the caller asks for the CPU); ``arg:`` /
        ``aux:`` prefixes are stripped and extra entries ignored."""
        from .. import symbol as sym_mod
        symbol = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(symbol, [sym_mod.var(n) for n in input_names])
        if param_file:
            loaded = nd._load_tensors(param_file)
            if not isinstance(loaded, dict):
                raise MXNetError(f"{param_file} is not a parameter dict "
                                 "file")
            params = {k.partition(":")[2] if k.partition(":")[0] in
                      ("arg", "aux") and ":" in k else k: v
                      for k, v in loaded.items()}
            block._set_params(params, device=resolve_device(ctx))
        return block
