"""Module — symbolic training over one bound executor (counterpart of
``mxnet_tpu/module/module.py``; ref python/mxnet/module/module.py).

The reference's ``DataParallelExecutorGroup`` replicates one executor per
GPU and splits each batch; the port binds one executor on one device (the
first context given), as the JAX package does. Its executor runs the
symbol as CUDA graphs on the card (``symbol.executor``), and ``update``
applies the optimizer's per-parameter updater in place, so the graphs go
on reading the parameters where they live.
"""
from __future__ import annotations

import logging

import torch

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import current_context
from ..symbol.executor import _copy_into
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        if isinstance(context, (list, tuple)):
            if len(context) > 1:
                self.logger.warning(
                    "Module got %d contexts; the port binds one executor "
                    "on the first", len(context))
            context = context[0] if context else None
        self._context = context or current_context()
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._grad_req = "write"
        self._preloaded = None
        self._preloaded_states = None

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        from .. import ndarray as nd
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._grad_req = grad_req
        shapes = {desc[0]: tuple(desc[1]) for desc in data_shapes}
        for desc in label_shapes or []:
            shapes[desc[0]] = tuple(desc[1])
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        arg_names = self._symbol.list_arguments()
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if shape is None:
                raise MXNetError(f"bind: cannot infer shape of {name!r}; "
                                 "provide input shapes that determine it")
            args[name] = nd.zeros(shape, ctx=self._context)
        aux = {name: nd.zeros(shape, ctx=self._context)
               for name, shape in zip(self._aux_names, aux_shapes)}
        req = {}
        for name in arg_names:
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or \
                    name in self._fixed_param_names:
                req[name] = "null"
            else:
                req[name] = grad_req if for_training else "null"
        self._exec = self._symbol.bind(self._context, args,
                                       grad_req=req, aux_states=aux)
        if shared_module is not None and shared_module._exec is not None:
            self._exec.copy_params_from(
                {k: v for k, v in shared_module._exec.arg_dict.items()
                 if k in self._param_names},
                shared_module._exec.aux_dict, allow_extra_params=True)
        self.binded = True

    # -- params --------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the bound parameters from ``arg_params`` / ``aux_params``
        (copied in place), else with ``initializer`` (``Uniform(0.01)``
        when None). A module from :meth:`load` starts from the loaded
        parameters."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if arg_params is None and aux_params is None and \
                self._preloaded is not None:
            arg_params, aux_params = self._preloaded
        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        for table, names, given in ((self._exec.arg_dict, self._param_names,
                                     arg_params),
                                    (self._exec.aux_dict, self._aux_names,
                                     aux_params)):
            for name in names:
                arr = table[name]
                if given is not None and name in given:
                    _copy_into(arr, given[name])
                else:
                    if given is not None and not allow_missing and \
                            table is self._exec.arg_dict:
                        raise MXNetError(f"arg_params given but {name!r} "
                                         "missing (allow_missing=False)")
                    initializer(name, arr._data)
        self.params_initialized = True

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """ref: Module.init_optimizer — ``rescale_grad`` defaults to 1 /
        batch, as the reference divides the summed loss gradient by the
        batch size; one updater keyed by parameter index."""
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {})
        if not isinstance(optimizer, opt_mod.Optimizer):
            if "rescale_grad" not in optimizer_params and \
                    getattr(self, "_data_shapes", None):
                batch = self._data_shapes[0][1][0]
                optimizer_params["rescale_grad"] = 1.0 / batch
            idx2name = dict(enumerate(self._param_names))
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preloaded_states is not None:
            self.load_optimizer_states(self._preloaded_states)
            self._preloaded_states = None

    def install_monitor(self, mon):
        """ref: Module.install_monitor — watch this module's executor."""
        if not self.binded:
            raise MXNetError("call bind before install_monitor")
        mon.install(self._exec)

    # -- execution -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise MXNetError("call bind before forward")
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        """The updater on each parameter with a gradient, in place."""
        if self._updater is None:
            raise MXNetError("call init_optimizer before update")
        with torch.no_grad():
            for i, name in enumerate(self._param_names):
                grad = self._exec.grad_dict.get(name)
                if grad is None:
                    continue
                self._updater(i, grad._data, self._exec.arg_dict[name]._data)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._symbol.list_outputs(), self._exec.outputs)))

    # -- checkpoint (ref: module.py save_checkpoint / load) ------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from .. import model
        arg_params, aux_params = self.get_params()
        model.save_checkpoint(prefix, epoch, self._symbol, arg_params,
                              aux_params)
        if save_optimizer_states:
            from ..resilience.atomic import atomic_write
            with atomic_write(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states(dump_optimizer=True))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix``'s symbol whose ``init_params`` starts
        from epoch ``epoch``'s parameters (and whose ``init_optimizer``
        restores the ``.states`` file when ``load_optimizer_states``)."""
        from .. import model
        sym, arg_params, aux_params = model.load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg_params, aux_params)
        mod._preloaded_states = f"{prefix}-{epoch:04d}.states" \
            if load_optimizer_states else None
        return mod

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
