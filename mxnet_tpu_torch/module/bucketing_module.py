"""BucketingModule — one executor per bucket (counterpart of
``mxnet_tpu/module/bucketing_module.py``; ref python/mxnet/module/
bucketing_module.py).

The reference binds one GraphExecutor per bucket, sharing memory with the
largest. Here each bucket's executor captures its own graphs (one per
bucket shape, the JAX package's per-shape jit cache), and the buckets
share one set of parameter tensors: a new bucket's executor binds the
default bucket's arrays by name, so an update reaches every bucket.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bind_kwargs = {}

    @property
    def symbol(self):
        return self._curr_module.symbol

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self._bind_kwargs = dict(for_training=for_training,
                                 inputs_need_grad=inputs_need_grad,
                                 grad_req=grad_req)
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, **self._bind_kwargs)
        self._buckets[self._default_bucket_key] = module
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """ref: BucketingModule.switch_bucket — bind a new bucket sharing
        parameters with the default bucket."""
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, **self._bind_kwargs)
            default = self._buckets[self._default_bucket_key]
            # share parameter arrays with the default bucket (the
            # reference's shared_exec memory sharing)
            for name in module._param_names:
                if name in default._exec.arg_dict and \
                        default._exec.arg_dict[name].shape == \
                        module._exec.arg_dict[name].shape:
                    module._exec.arg_dict[name] = \
                        default._exec.arg_dict[name]
                    if name in default._exec.grad_dict:
                        module._exec.grad_dict[name] = \
                            default._exec.grad_dict[name]
            for name in module._aux_names:
                if name in default._exec.aux_dict and \
                        default._exec.aux_dict[name].shape == \
                        module._exec.aux_dict[name].shape:
                    module._exec.aux_dict[name] = \
                        default._exec.aux_dict[name]
            module.params_initialized = True
            module._updater = default._updater
            module._optimizer = default._optimizer
            module.optimizer_initialized = default.optimizer_initialized
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
        if getattr(self, "_monitor", None) is not None:
            self._curr_module.install_monitor(self._monitor)

    def install_monitor(self, mon):
        """ref: BucketingModule.install_monitor — every bucket's executor
        reports to the same Monitor (new buckets pick it up on switch)."""
        if not self.binded:
            from ..base import MXNetError
            raise MXNetError("call bind before install_monitor")
        self._monitor = mon
        for module in self._buckets.values():
            module.install_monitor(mon)

    def init_params(self, *args, **kwargs):
        self._buckets[self._default_bucket_key].init_params(*args, **kwargs)
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """ref: BucketingModule.set_params — applied via the current
        bucket; buckets share parameter storage by name with the default
        bucket (switch_bucket), so shared entries update everywhere."""
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(*args, **kwargs)
        for key, mod in self._buckets.items():
            if key != self._default_bucket_key:
                mod._updater = default._updater
                mod._optimizer = default._optimizer
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is None:
            key = self._curr_bucket_key
        if key != self._curr_bucket_key or key not in self._buckets:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def _grad_datas(self):
        # guardrails see the active bucket's executor — the one whose
        # gradients the next update() would apply
        if self._curr_module is None:
            return None
        return self._curr_module._grad_datas()

    def _guard_optimizers(self):
        # every bucket shares the default bucket's optimizer object
        # (init_optimizer/switch_bucket above), so one backoff covers all
        default = self._buckets.get(self._default_bucket_key) \
            if self._buckets else None
        return default._guard_optimizers() if default is not None else []

    def _guard_reinit_updaters(self):
        default = self._buckets.get(self._default_bucket_key) \
            if self._buckets else None
        if default is None:
            return
        default._guard_reinit_updaters()
        for key, mod in self._buckets.items():
            if mod is not default:
                # re-share the fresh updater exactly as init_optimizer does
                mod._updater = default._updater
                mod._optimizer = default._optimizer

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)
