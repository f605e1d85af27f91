"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``, ref
``python/mxnet/gluon/trainer.py``), for one device.

``Trainer(net.collect_params(), "adam", {"learning_rate": 1e-4})`` takes
the tensors of the dict that require grad (``collect_params()`` also
lists buffers, such as BatchNorm's running statistics, which are not
trained). ``step(batch_size)`` sets ``rescale_grad = scale / batch_size``
and applies the optimizer to every weight with its ``.grad``, in place.
A weight that no backward reached is updated with a zero gradient, as the
reference's zero-filled gradient buffer gives. There is no KVStore: on
one device ``allreduce_grads`` has nothing to do. Weight ``i`` of the
dict (buffers counted) is the optimizer's index ``i``, and the tensors
go to the optimizer as its ``param_dict``, so their ``lr_mult`` and
``wd_mult`` attributes scale its lr and wd.

With fp16 AMP (``contrib.amp.init("float16")`` and ``amp.init_trainer``)
or a ``guard=`` (:class:`~mxnet_tpu_torch.guardrails.GuardConfig`),
``step`` checks every gradient with one fused reduction and one host
read: a non-finite step skips the update, leaving weights and optimizer
state untouched, journals a ``nonfinite_grad`` record, halves the loss
scale if there is one and counts against the guard's divergence budget;
``GuardConfig.clip_norm`` clips the gradients' global norm off the same
reduction. bf16 has fp32's exponent range, so without a guard no check
runs.

``save_states``/``load_states`` write and read the updater's pickle
(the states and the optimizer); ``checkpoint``/``restore`` commit and
restore a step directory (``resilience.commit``) holding every tensor
of the dict (weights and buffers, ``<prefix>.params``, keyed by the
dict's names) and the states. A load copies into the live tensors in
place. With ``GuardConfig(ckpt_root=)`` a divergence restores the
newest valid step and backs the lr off.

A weight whose gradient is a sparse COO tensor (``nn.Embedding(
sparse_grad=True)``, ``grad_stype`` "row_sparse") is updated on its
touched rows alone (``Optimizer.update_row_sparse``, the reference's
lazy update), and the guard reads and clips those rows' values. The
gradient is then marked consumed: a ``step`` without a new backward
applies nothing to that weight, where a dense weight gets a zero
gradient.
"""
from __future__ import annotations

import torch

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..guardrails import fused
from ..guardrails.monitor import (AnomalyMonitor, GuardConfig,
                                  handle_divergence,
                                  journal_scaler_only_skip)
from ..observability import instrument as _obs
from ..parallel import _ckpt
from ..resilience.atomic import atomic_write

__all__ = ["Trainer"]


def _values(grad):
    """What the guard reads and clips of a gradient: a sparse one's stored
    values (a view: clipping them scales the gradient)."""
    return grad._values() if grad.is_sparse else grad


def _consumed(grad):
    return grad.is_sparse and getattr(grad, "_mx_consumed", False)


class Trainer:
    """ref: gluon.Trainer — ``step(batch_size)`` = allreduce (nothing on
    one device) + update."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 guard=None):
        if hasattr(params, "values"):
            self._names = [str(k) for k in params.keys()]
            params = list(params.values())
        else:
            self._names = [str(i) for i in range(len(params))]
        if not isinstance(params, (list, tuple)):
            raise MXNetError("Trainer expects a dict of parameters (e.g. "
                             "collect_params()) or a list of tensors")
        for p in params:
            if not isinstance(p, torch.Tensor):
                raise MXNetError(f"invalid parameter {p!r}")
        self._all = list(params)
        self._index = [i for i, p in enumerate(params) if p.requires_grad]
        self._params = [params[i] for i in self._index]
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(params))
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)
        self._guard_cfg = GuardConfig.coerce(guard)
        if self._guard_cfg is not None \
                and self._guard_cfg.mode == "deferred":
            # the eager path decides every step on the host, so deferred
            # mode's promise of no per-step read cannot hold here
            raise MXNetError(
                "GuardConfig(mode='deferred') needs a fused trainer "
                "(parallel.ShardedTrainer / PipelinedTrainer): the "
                "eager Trainer makes its skip decision on the host "
                "every step — use mode='step' (docs/guardrails.md)")
        self._monitor = (AnomalyMonitor(self._guard_cfg,
                                        consumer="gluon_trainer")
                         if self._guard_cfg is not None else None)
        self._step_count = 0
        self._skipped_steps = 0

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def skipped_steps(self):
        """Steps skipped on a non-finite gradient so far."""
        return self._skipped_steps

    def _active_scaler(self):
        """The fp16 loss scaler, or None: bf16 cannot overflow where fp32
        does not, so its steps are not checked."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            from ..contrib.amp import amp_dtype
            if amp_dtype() != "float16":
                scaler = None
        return scaler

    def step(self, batch_size, ignore_stale_grad=False, loss=None):
        """Rescale by ``1 / batch_size`` and update (ref: Trainer.step).
        With an fp16 loss scaler or a guard, one fused finiteness check
        over the gradients (and ``loss``'s mean, when given: it also
        feeds the monitor's loss-spike detection) and one host read
        decide the step: a non-finite step skips the update, journals,
        halves the scale and counts against the budget; the guard's
        ``clip_norm`` then scales the gradients. A weight no backward
        reached is updated with a zero gradient either way
        (``ignore_stale_grad`` changes nothing). Traced as
        ``gluon_trainer.step`` with the ``allreduce``, ``guard_fetch``
        (with a scaler or a guard) and ``update`` phases."""
        with _obs.trace.span("gluon_trainer.step",
                             step=self._step_count + 1):
            with _obs.step_phase("gluon_trainer", "allreduce"):
                self.allreduce_grads()
            self._guarded_update(batch_size, loss)

    def _guard_ok(self, loss):
        """The fused check of a step with an fp16 scaler or a guard, and
        the clip; True when the update may run."""
        scaler = self._active_scaler()
        if scaler is None and self._guard_cfg is None:
            return True
        grads = [_values(p.grad) for p in self._params
                 if p.grad is not None and not _consumed(p.grad)]
        mean = None if loss is None else torch.mean(loss.float())
        finite, gnorm = fused.guard_stats(grads, mean)
        row = [finite.float(), gnorm] + ([] if mean is None else [mean])
        ok, gn, *loss_v = fused.host_fetch(torch.stack(row))[0]
        if not self._note_guard_outcome(bool(ok), gn, scaler,
                                        loss_v[0] if loss_v else None):
            return False
        self._apply_guard_clip(grads, gnorm)
        return True

    def _note_guard_outcome(self, ok, gn, scaler, loss=None):
        """Counters, loss-scale feedback, the monitor and divergence
        (ref: Trainer._note_guard_outcome). True when the update may
        run."""
        if scaler is not None and gn is not None:
            # journal the norm the gradients carry before the scale
            gn = gn * self._scale
        if ok:
            if self._monitor is not None:
                verdict = self._monitor.observe(self._step_count, True,
                                                loss=loss, grad_norm=gn)
                if verdict == "diverged":    # sustained finite-loss spike
                    self._handle_divergence()
                    return False
            return True
        self._skipped_steps += 1
        if scaler is not None:
            scaler.update_scale(True)
        if self._monitor is not None:
            verdict = self._monitor.observe(self._step_count, False,
                                            loss=loss, grad_norm=gn)
            if verdict == "diverged":
                self._handle_divergence()
        else:
            journal_scaler_only_skip(self._step_count, gn, loss,
                                     "gluon_trainer",
                                     total_skips=self._skipped_steps)
        return False

    def _apply_guard_clip(self, grads, gnorm):
        """The guard's global-norm clip off its own norm: the threshold
        is on the rescaled gradients' norm (ref: Trainer._apply_guard_clip
        → clip_global_norm(..., global_norm=))."""
        cfg = self._guard_cfg
        if cfg is None or cfg.clip_norm is None:
            return
        scale = fused.clip_scale(
            gnorm, cfg.clip_norm / max(self._optimizer.rescale_grad, 1e-30))
        with torch.no_grad():
            for g in grads:
                g.mul_(scale.to(g.dtype))

    def _handle_divergence(self):
        # the optimizer as a getter: restore() -> load_states replaces
        # self._optimizer, and the lr backoff must land on the new one
        handle_divergence(
            self._monitor, self._step_count,
            restore_fn=lambda: self.restore(self._guard_cfg.ckpt_root),
            optimizer=lambda: self._optimizer)

    # -- checkpoints (ref: Trainer.checkpoint / restore / save_states) -------
    def checkpoint(self, ckpt_dir, step=None, keep_last=None):
        """Stage the tensors and the states under
        ``<ckpt_dir>/step-N.tmp`` and publish them behind a CRC manifest
        and a rename. ``step`` defaults to the count of ``step()`` calls.
        Returns the committed step."""
        def save_cb(prefix):
            self._save_params_file(f"{prefix}.params")
            self.save_states(f"{prefix}.states")

        step = int(self._step_count if step is None else step)
        return _ckpt.commit_checkpoint(ckpt_dir, step, save_cb,
                                       keep_last=keep_last)

    def restore(self, ckpt_dir, step=None):
        """Restore the newest valid committed step (a corrupt or torn
        newer one is skipped and journaled as ``ckpt_fallback``), or the
        pinned ``step``. Returns the restored step."""
        def load_cb(prefix):
            self._load_params_file(f"{prefix}.params")
            self.load_states(f"{prefix}.states")

        restored = _ckpt.restore_checkpoint(ckpt_dir, load_cb, step=step)
        self._step_count = restored
        return restored

    def _save_params_file(self, fname):
        nd.save(fname, dict(zip(self._names, self._all)))

    def _load_params_file(self, fname):
        """Every tensor of the dict from ``fname``, each checked before
        any is copied in place."""
        loaded = nd._load_tensors(fname)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{fname} is not a parameter dict file")
        pairs = []
        for name, p in zip(self._names, self._all):
            if name not in loaded:
                raise MXNetError(f"checkpoint {fname} is missing "
                                 f"parameter {name!r}")
            value = loaded[name]
            if tuple(value.shape) != tuple(p.shape):
                raise MXNetError(f"set_data shape {tuple(value.shape)} != "
                                 f"parameter shape {tuple(p.shape)} for "
                                 f"{name}")
            pairs.append((p, value))
        _ckpt.copy_into(pairs)

    def save_states(self, fname):
        """The updater's states and the optimizer, atomically (ref:
        Trainer.save_states)."""
        with atomic_write(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Restore ``save_states``' file: the states in place where they
        exist, and the pickled optimizer in place of this one (ref:
        Trainer.load_states)."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer

    def allreduce_grads(self):
        """Nothing to reduce on one device (ref: Trainer.allreduce_grads)."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step`` (ref: Trainer.update), guarded as
        ``step`` is."""
        self._guarded_update(batch_size, None)

    def _guarded_update(self, batch_size, loss):
        self._step_count += 1
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._guard_cfg is not None or \
                self._active_scaler() is not None:
            with _obs.step_phase("gluon_trainer", "guard_fetch"):
                ok = self._guard_ok(loss)
            if not ok:
                return
        with _obs.step_phase("gluon_trainer", "update"):
            for i, weight in zip(self._index, self._params):
                grad = weight.grad
                if grad is None:
                    grad = torch.zeros_like(weight)
                elif grad.is_sparse:
                    if _consumed(grad):
                        continue      # a stale sparse gradient: no rows
                    grad._mx_consumed = True
                self._updater(i, grad, weight)
        scaler = self._active_scaler()
        if scaler is not None:
            scaler.update_scale(False)
