"""SequentialModule — a chain of modules (counterpart of
``mxnet_tpu/module/sequential_module.py``; ref python/mxnet/module/
sequential_module.py).

Each module's outputs feed the next module's data, and the input
gradients go back along the chain; every child is its own bound
executor. (Composing the symbols into one Module runs them as one
program instead.)
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Add a module to the chain. kwargs: ``take_labels`` (this module
        needs the data batch's labels, e.g. the one holding the loss) and
        ``auto_wiring`` (rename the previous module's outputs, in order,
        to this module's data names)."""
        bad = set(kwargs) - {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        if bad:
            raise MXNetError(f"SequentialModule.add: unknown meta {bad}")
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self          # chaining, like the reference

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        return self._modules[0]._data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1]._symbol.list_outputs() if self._modules else []

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule is empty — call add() first")
        if shared_module is not None:
            raise MXNetError("SequentialModule does not support shared_module "
                             "(same as the reference)")
        self.for_training = for_training
        self._label_shapes = label_shapes
        cur_shapes = list(data_shapes)
        n = len(self._modules)
        for i, (mod, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            # intermediate modules need input grads so backward can chain
            need_grad = inputs_need_grad if i == 0 else True
            mod.bind(cur_shapes,
                     label_shapes=label_shapes if take_labels else None,
                     for_training=for_training,
                     inputs_need_grad=need_grad,
                     force_rebind=force_rebind, grad_req=grad_req)
            if i < n - 1:
                # output shapes of this module feed the next
                shapes = {name: tuple(shape) for name, shape in
                          [(d[0], d[1]) for d in cur_shapes]}
                if take_labels and label_shapes:
                    shapes.update({d[0]: tuple(d[1]) for d in label_shapes})
                _, out_shapes, _ = mod._symbol.infer_shape(**shapes)
                out_names = mod._symbol.list_outputs()
                nxt = self._modules[i + 1]
                if self._metas[i + 1].get(self.META_AUTO_WIRING, False):
                    names = nxt._data_names
                    if len(names) != len(out_names):
                        raise MXNetError(
                            f"auto_wiring: module {i} emits "
                            f"{len(out_names)} outputs but module {i+1} "
                            f"takes {len(names)} inputs")
                    cur_shapes = list(zip(names, out_shapes))
                else:
                    cur_shapes = list(zip(out_names, out_shapes))
        self.binded = True

    # -- params --------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        seen = set()
        for mod in self._modules:
            mod.init_params(initializer=initializer, arg_params=arg_params,
                            aux_params=aux_params, allow_missing=True,
                            force_init=force_init, allow_extra=True)
            dup = seen & set(mod._param_names)
            if dup:
                raise MXNetError(f"duplicate parameter names across chained "
                                 f"modules: {sorted(dup)} (the reference "
                                 f"forbids this too)")
            seen |= set(mod._param_names)
        self.params_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        for mod in self._modules:
            mod.set_params(arg_params, aux_params, allow_missing=True,
                           force_init=force_init, allow_extra=True)
        self.params_initialized = True

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        for mod in self._modules:
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        self.optimizer_initialized = True

    # -- execution -----------------------------------------------------------
    def install_monitor(self, mon):
        """ref: SequentialModule.install_monitor — every sub-module's
        executor reports to the same Monitor."""
        if not self.binded:
            raise MXNetError("call bind before install_monitor")
        for module in self._modules:
            module.install_monitor(mon)

    def forward(self, data_batch, is_train=None):
        from ..io import DataBatch
        if not self.binded:
            raise MXNetError("call bind before forward")
        data = data_batch.data
        for i, (mod, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            label = data_batch.label if take_labels else None
            mod.forward(DataBatch(data=data, label=label),
                        is_train=is_train)
            if i < len(self._modules) - 1:
                data = mod.get_outputs()

    def backward(self, out_grads=None):
        grads = out_grads
        for i in range(len(self._modules) - 1, -1, -1):
            self._modules[i].backward(grads)
            grads = self._modules[i].get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def _grad_datas(self):
        # guardrails see every chained module's gradients: update()
        # applies them all, so a NaN anywhere must veto the whole step
        out = []
        for mod in self._modules:
            g = mod._grad_datas()
            if g is None:
                return None
            out.extend(g)
        return out or None

    def _guard_optimizers(self):
        # chained modules may each own an optimizer (init_optimizer
        # above creates one per module from a string spec): the rollback
        # LR backoff must land on every distinct one
        out, seen = [], set()
        for mod in self._modules:
            for opt in mod._guard_optimizers():
                if id(opt) not in seen:
                    seen.add(id(opt))
                    out.append(opt)
        return out

    def _guard_reinit_updaters(self):
        for mod in self._modules:
            mod._guard_reinit_updaters()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        for mod, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                mod.update_metric(eval_metric, labels, pre_sliced=pre_sliced)
