"""BaseModule — the symbolic training loop (counterpart of
``mxnet_tpu/module/base_module.py``; ref python/mxnet/module/
base_module.py): ``fit`` with epoch checkpoints, resume, the SIGTERM
preemption watch and the anomaly guard, ``score``, ``predict`` and
``forward_backward``. The bind is traced as the module path's compile
event (``module_bind``), each epoch and step as ``module_fit.epoch`` and
``module_fit.step`` with the step phases of ``observability``."""
from __future__ import annotations

import logging
import os
import re
import time

from .. import metric as metric_mod
from ..base import MXNetError
from ..observability import instrument as _obs

__all__ = ["BaseModule"]


class BaseModule:
    """ref: base_module.py BaseModule — fit/score/predict skeleton."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract ------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError

    # -- composite -----------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _grad_datas(self):
        """Device arrays of the PARAMETER gradient buffers, or None when
        the concrete module type does not expose them (guardrails then
        skip the finiteness check rather than guess). Data-input grads
        (``inputs_need_grad=True``) are excluded: the optimizer never
        consumes them, so they must not veto the step or inflate the
        journaled global norm."""
        exec_ = getattr(self, "_exec", None)
        if exec_ is None:
            return None
        names = getattr(self, "_param_names", None)
        grads = (exec_.grad_dict.values() if names is None
                 else (exec_.grad_dict.get(n) for n in names))
        return [g._data for g in grads if g is not None]

    def _guard_optimizers(self):
        """Live optimizer object(s) the guard's rollback LR backoff
        must land on (composite module types override — e.g. a chained
        SequentialModule has one per inner module)."""
        opt = getattr(self, "_optimizer", None)
        return [opt] if opt is not None else []

    def _guard_reinit_updaters(self):
        """Drop the diverged trajectory's updater state (often
        saturated moments) while keeping the same optimizer object —
        the rollback's LR backoff lands on it right after."""
        opt = getattr(self, "_optimizer", None)
        if opt is not None:
            self.init_optimizer(optimizer=opt, force_init=True)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """ref: BaseModule.score."""
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """ref: BaseModule.predict."""
        from .. import ndarray as nd
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outs = [o[:o.shape[0] - pad] for o in self.get_outputs()]
            outputs.append(outs)
        if not outputs:
            return []
        num_out = len(outputs[0])
        if merge_batches:
            merged = [nd.concat(*[b[i] for b in outputs], dim=0)
                      for i in range(num_out)]
            if num_out == 1 and not always_output_list:
                return merged[0]
            return merged
        return outputs

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None,
            checkpoint_prefix=None, checkpoint_period=1, keep_last=None,
            resume=False, guard=None):
        """The reference's canonical symbolic training loop
        (ref: base_module.py BaseModule.fit, SURVEY §3.3).

        Crash consistency (docs/checkpointing.md): with
        ``checkpoint_prefix`` set, fit installs an atomic epoch-end
        checkpoint (``keep_last``-bounded retention) and a SIGTERM
        preemption watch — a preemption saves one checkpoint at the
        next batch boundary, journals ``preempt_checkpoint``, and
        returns. ``resume=True`` restarts from the newest *valid*
        checkpoint under the prefix, skipping torn/corrupt files with a
        journaled ``ckpt_fallback`` (a fresh start when none exists).

        Anomaly guardrails (docs/guardrails.md): ``guard=True`` (or a
        :class:`~..guardrails.GuardConfig`) checks the batch's
        gradients with ONE fused device-side finiteness reduction before
        ``update()`` — a non-finite batch is skipped and journaled
        (``nonfinite_grad``), never trained on. Past the anomaly budget,
        fit rolls back to the newest valid checkpoint under
        ``checkpoint_prefix`` with an LR backoff (bounded retries),
        else raises :class:`~..guardrails.TrainingDiverged`."""
        from ..diagnostics.journal import get_journal
        if num_epoch is None:
            raise MXNetError("fit() requires num_epoch")
        watch = None
        if resume and not checkpoint_prefix:
            raise MXNetError("fit(resume=True) needs checkpoint_prefix=")
        if checkpoint_prefix:
            from .. import callback as callback_mod
            from ..resilience import preempt
            cbs = list(_as_list(epoch_end_callback or []))
            cbs.append(callback_mod.do_checkpoint(
                checkpoint_prefix, checkpoint_period, keep_last=keep_last))
            epoch_end_callback = cbs
            # re-arm: a SIGTERM consumed by a previous fit() in this
            # process must not mute preemption handling for this run
            # (a live unconsumed signal stays latched)
            watch = preempt.install()
            watch.rearm()
        if resume:
            from .. import model
            found = model.load_latest_params(checkpoint_prefix)
            if found is not None:
                arg_params, aux_params, begin_epoch = found
                force_init = True
                get_journal().event("resume", prefix=checkpoint_prefix,
                                    epoch=begin_epoch)
                self.logger.info("fit(resume=True): resuming from epoch "
                                 "%d of %s", begin_epoch, checkpoint_prefix)
            else:
                get_journal().event("resume_fresh",
                                    prefix=checkpoint_prefix)
        # bind builds the symbolic executor — the module path's compile
        # event (counted/timed/traced like the trainers' jit misses)
        with _obs.maybe_compile_span(
                not self.binded or force_rebind, "module_bind",
                shapes=[list(d[1]) for d in train_data.provide_data]):
            self.bind(data_shapes=train_data.provide_data,
                      label_shapes=train_data.provide_label,
                      for_training=True, force_rebind=force_rebind)
        if initializer is None:
            from .. import initializer as init_mod
            initializer = init_mod.Uniform(0.01)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        if monitor is not None:
            self.install_monitor(monitor)
        anomaly_monitor = None
        if guard is not None:
            from ..guardrails.monitor import AnomalyMonitor, GuardConfig
            guard_cfg = GuardConfig.coerce(guard)
            if guard_cfg is not None and guard_cfg.mode == "deferred":
                # same contract as the eager Trainer: fit decides every
                # batch on the host, deferred cannot hold here
                raise MXNetError(
                    "GuardConfig(mode='deferred') needs a fused trainer "
                    "(parallel.ShardedTrainer / PipelinedTrainer); "
                    "module.fit checks every batch on the host — use "
                    "mode='step' (docs/guardrails.md)")
            if guard_cfg is not None:
                # fit adapts the config (_guarded_veto points ckpt_root
                # at checkpoint_prefix on divergence) — copy so a
                # caller-shared GuardConfig is never mutated
                anomaly_monitor = AnomalyMonitor(guard_cfg.copy(),
                                                 consumer="module_fit")
        global_step = 0

        try:
            for epoch in range(begin_epoch, num_epoch):
                # monotonic, not wall clock: an NTP step mid-epoch must
                # not produce a negative Time cost (G11)
                tic = time.monotonic()
                eval_metric.reset()
                train_data.reset()
                # the epoch span covers the whole epoch including the
                # end-of-epoch callbacks — a do_checkpoint commit nests
                # under the epoch it belongs to
                with _obs.trace.span("module_fit.epoch", epoch=epoch):
                    stop = self._fit_epoch(
                        train_data, eval_metric, epoch, monitor,
                        anomaly_monitor, checkpoint_prefix,
                        batch_end_callback, watch, global_step)
                    global_step = stop[1]
                    if stop[0]:
                        return
                    for name, val in eval_metric.get_name_value():
                        self.logger.info("Epoch[%d] Train-%s=%f", epoch,
                                         name, val)
                    self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                     time.monotonic() - tic)
                    if epoch_end_callback is not None:
                        arg_params, aux_params = self.get_params()
                        for cb in _as_list(epoch_end_callback):
                            cb(epoch, self.symbol, arg_params, aux_params)
                    if eval_data is not None:
                        res = self.score(
                            eval_data, validation_metric,
                            batch_end_callback=eval_batch_end_callback,
                            epoch=epoch)
                        for name, val in res:
                            self.logger.info("Epoch[%d] Validation-%s=%f",
                                             epoch, name, val)
        finally:
            if watch is not None:
                # nothing polls the watch after fit: restore the
                # displaced SIGTERM disposition (else the process would
                # silently ignore termination forever)
                watch.uninstall()

    def _fit_epoch(self, train_data, eval_metric, epoch, monitor,
                   anomaly_monitor, checkpoint_prefix, batch_end_callback,
                   watch, global_step):
        """One fit() epoch's batch loop, instrumented with the step
        phases (data_wait / forward_backward / guard_fetch / update —
        docs/observability.md).  Returns ``(stopped, global_step)``;
        ``stopped`` is True on a preemption checkpoint."""
        from ..diagnostics.journal import get_journal
        batches = enumerate(train_data)
        while True:
            with _obs.step_phase("module_fit", "data_wait"):
                try:
                    nbatch, data_batch = next(batches)
                except StopIteration:
                    break
            with _obs.trace.span("module_fit.step", epoch=epoch,
                                 nbatch=nbatch, step=global_step + 1):
                if monitor is not None:
                    monitor.tic()
                with _obs.step_phase("module_fit", "forward_backward"):
                    self.forward_backward(data_batch)
                global_step += 1
                if anomaly_monitor is not None:
                    with _obs.step_phase("module_fit", "guard_fetch"):
                        vetoed = self._guarded_veto(
                            anomaly_monitor, global_step,
                            checkpoint_prefix)
                else:
                    vetoed = False
                if not vetoed:
                    with _obs.step_phase("module_fit", "update"):
                        self.update()
                if monitor is not None:
                    monitor.toc_print()
                if not vetoed:
                    # a vetoed batch's forward outputs are the
                    # anomaly (NaN) — one poisoned batch must not
                    # poison the epoch's running training metric
                    self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric,
                                          locals()))
                if watch is not None and watch.consume():
                    # preemption: save at this step boundary and
                    # stop. Saving with the CURRENT epoch number
                    # means resume re-runs this (partial) epoch —
                    # conservative, never skips data.
                    arg_p, aux_p = self.get_params()
                    from .. import model
                    model.save_checkpoint(checkpoint_prefix, epoch,
                                          self.symbol, arg_p, aux_p)
                    get_journal().event(
                        "preempt_checkpoint",
                        prefix=checkpoint_prefix,
                        epoch=epoch, nbatch=nbatch)
                    self.logger.warning(
                        "SIGTERM: checkpoint saved at epoch %d batch "
                        "%d (%s); stopping fit", epoch, nbatch,
                        checkpoint_prefix)
                    return True, global_step
        return False, global_step

    def _guarded_veto(self, anomaly_monitor, global_step,
                      checkpoint_prefix):
        """Guardrails decision for one fit() batch: True vetoes the
        update (non-finite gradients — skip-step). Divergence rolls the
        module back to the newest valid epoch checkpoint with an LR
        backoff, or raises TrainingDiverged once the budget is spent."""
        from ..guardrails import fused
        from ..guardrails.monitor import handle_divergence
        grads = self._grad_datas()
        if not grads:
            if not getattr(self, "_guard_blind_warned", False):
                # a guard that silently protects nothing is worse than
                # none — tell the user once per module
                self._guard_blind_warned = True
                import warnings
                warnings.warn(
                    f"fit(guard=...) on {type(self).__name__}: gradient "
                    "buffers are not visible (_grad_datas returned "
                    "nothing), so the anomaly guard cannot check this "
                    "module's steps (docs/guardrails.md)")
            return False
        finite_dev, gnorm_dev = fused.guard_stats(grads)
        ok, gn = fused.host_fetch(finite_dev, gnorm_dev)
        verdict = anomaly_monitor.observe(global_step, bool(ok),
                                          grad_norm=gn)
        if verdict == "diverged":
            if checkpoint_prefix and anomaly_monitor.cfg.ckpt_root is None:
                # fit's checkpoints are epoch files under the prefix —
                # point the rollback there unless a commit root was
                # explicitly configured
                anomaly_monitor.cfg.ckpt_root = checkpoint_prefix

            def restore_fn():
                from .. import model
                root = anomaly_monitor.cfg.ckpt_root
                found = model.load_latest_params(root)
                if found is None:
                    # lenient layout sniff (committed dirs are strictly
                    # step-%08d, but a hand-built or half-migrated root
                    # deserves the same explanation)
                    try:
                        entries = os.listdir(root)
                    except OSError:
                        entries = []
                    looks_like_commit_root = any(
                        e == "latest" or
                        (re.match(r"^step-\d+$", e) and
                         os.path.isdir(os.path.join(root, e)))
                        for e in entries)
                    if looks_like_commit_root:
                        raise MXNetError(
                            f"ckpt_root {root!r} is a resilience.commit "
                            "directory, but module.fit rolls back to "
                            "EPOCH checkpoints (`prefix-NNNN.params` "
                            "files written under checkpoint_prefix=) — "
                            "point ckpt_root at an epoch-file prefix, "
                            "or leave it unset to use "
                            "checkpoint_prefix; the commit protocol is "
                            "the fused trainers' checkpoint()/restore() "
                            "format (docs/guardrails.md)")
                    raise MXNetError(
                        f"no loadable checkpoint under {root!r} to roll "
                        "back to")
                arg_params, aux_params, ckpt_epoch = found
                self.set_params(arg_params, aux_params, force_init=True)
                # epoch checkpoints hold params only — the diverged
                # trajectory's updater moments (often saturated) must
                # not survive into the restored world, or the run can
                # re-diverge immediately and burn the rollback budget.
                # Re-deriving the updater from the SAME optimizer object
                # resets its state while keeping the LR-backoff target
                # (handle_divergence backs off the optimizers after
                # this returns).
                self._guard_reinit_updaters()
                return ckpt_epoch

            handle_divergence(anomaly_monitor, global_step, restore_fn,
                              optimizer=self._guard_optimizers)
            return True
        return not bool(ok)

    @property
    def symbol(self):
        return self._symbol


class _BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, local_vars):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = local_vars


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
