"""Host-side anomaly accounting: skip budget, divergence detection,
rollback orchestration (counterpart of
``mxnet_tpu/guardrails/monitor.py``).

The fused guard (:mod:`.fused`) decides *this step*
in-program; this module owns the *trajectory*: how many steps have been
skipped in a row, whether the loss is running away even while finite,
and what to do when the anomaly budget is exhausted — roll back to the
newest CRC-valid committed checkpoint with a learning-rate backoff
(bounded retries), or surface a structured :class:`TrainingDiverged`.

Import-light (numpy, the diagnostics journal and ``resilience.retry``'s
environment readers): the monitor is built before any device is
touched.

Rollback restores through the trainer's own ``restore(ckpt_root)`` (the
commit protocol's newest valid step) and backs the lr off, compounded
across rollbacks (:func:`set_cumulative_lr_backoff`).

Journal records (the JAX package's docs/guardrails.md has the full schema):

- ``nonfinite_grad``   one per skipped step: step, grad_norm, loss,
  consecutive-skip count, consumer (which trainer path).
- ``loss_spike``       one per sustained-spike observation window.
- ``divergence_rollback``  step, restored_step, reason, lr_backoff,
  rollback ordinal.

Knobs (all overridable per-:class:`GuardConfig`):

- ``MXNET_TPU_GUARD_MAX_SKIPS``     consecutive non-finite steps before
  the run is declared divergent (default 4).
- ``MXNET_TPU_GUARD_SPIKE_FACTOR``  finite-loss spike threshold as a
  multiple of the rolling median (default 10).
- ``MXNET_TPU_GUARD_WINDOW``        rolling loss window length
  (default 50).
- ``MXNET_TPU_GUARD_SPIKE_STEPS``   consecutive spiking steps before
  divergence (default 5).
- ``MXNET_TPU_GUARD_LR_BACKOFF``    learning-rate factor applied at
  each rollback (default 0.5).
- ``MXNET_TPU_GUARD_MAX_ROLLBACKS`` rollback budget before
  :class:`TrainingDiverged` escapes (default 2).
"""
from __future__ import annotations

import collections

import numpy as np

from ..base import MXNetError
from ..diagnostics.journal import get_journal
from ..resilience.retry import _env_float, _env_int

__all__ = ["AnomalyMonitor", "GuardConfig", "TrainingDiverged",
           "handle_divergence", "journal_scaler_only_skip",
           "set_cumulative_lr_backoff", "stale_scale_runs"]


def stale_scale_runs(finites):
    """Per-step collapse mask for a scanned fp16 window: ``True`` marks
    a follow-on overflow of a consecutive run — every step after the
    run's first overflow re-decided under the same frozen loss scale,
    so only the first one feeds the scaler and the skip budget. THE
    single definition of the run boundary, shared by
    :meth:`AnomalyMonitor.observe_window` and the trainers' scaler
    feed (``GuardedTrainerMixin._after_run_steps``)."""
    mask, prev_bad = [], False
    for f in finites:
        bad = not bool(f)
        mask.append(bad and prev_bad)
        prev_bad = bad
    return mask


class GuardConfig:
    """Anomaly-guardrail policy for one trainer.

    ``mode="step"`` (default) fetches the step's (flag, loss, norm)
    outputs each step — one ``host_fetch`` of already-computed outputs,
    the same cost as reading the loss for logging — enabling per-step
    journaling, divergence detection and rollback. ``mode="deferred"``
    does ZERO per-step host reads: skip counters accumulate in-program
    and ``trainer.guard_poll()`` fetches them on demand (fp16 dynamic
    loss scaling still needs ``"step"`` — the scale is a host-side
    input).

    ``ckpt_root`` names a ``resilience.commit`` checkpoint root (the
    trainers' ``checkpoint()/restore()`` format); with it set, a
    divergence triggers restore-newest-valid + LR backoff instead of
    raising (until ``max_rollbacks`` is spent). ``clip_norm`` enables
    global-norm gradient clipping off the guard's already-computed norm.
    """

    def __init__(self, max_consecutive_skips=None, spike_factor=None,
                 spike_window=None, spike_steps=None, lr_backoff=None,
                 max_rollbacks=None, ckpt_root=None, clip_norm=None,
                 mode="step"):
        self.max_consecutive_skips = int(
            max_consecutive_skips if max_consecutive_skips is not None
            else _env_int("MXNET_TPU_GUARD_MAX_SKIPS", 4))
        self.spike_factor = float(
            spike_factor if spike_factor is not None
            else _env_float("MXNET_TPU_GUARD_SPIKE_FACTOR", 10.0))
        self.spike_window = int(
            spike_window if spike_window is not None
            else _env_int("MXNET_TPU_GUARD_WINDOW", 50))
        self.spike_steps = int(
            spike_steps if spike_steps is not None
            else _env_int("MXNET_TPU_GUARD_SPIKE_STEPS", 5))
        self.lr_backoff = float(
            lr_backoff if lr_backoff is not None
            else _env_float("MXNET_TPU_GUARD_LR_BACKOFF", 0.5))
        self.max_rollbacks = int(
            max_rollbacks if max_rollbacks is not None
            else _env_int("MXNET_TPU_GUARD_MAX_ROLLBACKS", 2))
        self.ckpt_root = ckpt_root
        self.clip_norm = float(clip_norm) if clip_norm is not None else None
        if mode not in ("step", "deferred"):
            raise MXNetError(f"GuardConfig mode {mode!r}: expected 'step' "
                             "or 'deferred'")
        if self.max_consecutive_skips < 1:
            raise MXNetError("GuardConfig.max_consecutive_skips must be >= 1")
        if self.spike_window < 1:
            raise MXNetError("GuardConfig.spike_window must be >= 1")
        self.mode = mode

    @classmethod
    def coerce(cls, guard):
        """``None``/``False`` | ``True`` | GuardConfig → GuardConfig |
        None (the trainer-constructor convenience — ``False`` disables
        like ``None`` so a config-driven bool plumbs straight through)."""
        if guard is None or guard is False:
            return None
        if isinstance(guard, cls):
            return guard
        if guard is True:
            return cls()
        raise MXNetError(f"guard must be None, False, True or a "
                         f"GuardConfig, got {type(guard).__name__}")

    def copy(self):
        """Per-field copy. A trainer that adapts a config in place —
        e.g. ``fit()`` pointing ``ckpt_root`` at its
        ``checkpoint_prefix`` — must copy first so the caller's object
        (possibly shared with another trainer) stays untouched."""
        import copy as _copy
        return _copy.copy(self)


class TrainingDiverged(MXNetError):
    """Structured divergence error: the anomaly budget is spent and no
    rollback (or no further rollback) is available. Carries the step,
    the triggering reason, and the skip/rollback counts so callers can
    journal/report without parsing the message."""

    def __init__(self, step, reason, consecutive_skips=0, rollbacks=0):
        super().__init__(
            f"training diverged at step {step}: {reason} "
            f"(consecutive_skips={consecutive_skips}, "
            f"rollbacks_used={rollbacks})")
        self.step = int(step)
        self.reason = reason
        self.consecutive_skips = int(consecutive_skips)
        self.rollbacks = int(rollbacks)


class AnomalyMonitor:
    """Rolling trajectory statistics + the anomaly budget.

    ``observe(step, finite, loss, grad_norm)`` returns one of
    ``"ok"`` / ``"skip"`` / ``"diverged"`` and journals every skip as a
    structured ``nonfinite_grad`` record. Divergence fires on either
    budget: ``max_consecutive_skips`` non-finite steps in a row, or a
    finite loss above ``spike_factor ×`` the rolling median for
    ``spike_steps`` consecutive observations (the silent-divergence
    class a finiteness check alone cannot see)."""

    def __init__(self, config=None, journal=None, consumer="trainer"):
        self.cfg = config or GuardConfig()
        self._journal = journal
        self.consumer = consumer
        self.total_skips = 0
        self.consecutive_skips = 0
        self.rollbacks = 0
        self.reason = None
        self._losses = collections.deque(maxlen=self.cfg.spike_window)
        self._spike_run = 0

    @property
    def journal(self):
        return self._journal if self._journal is not None else get_journal()

    # -- per-step observation ------------------------------------------------
    def observe(self, step, finite, loss=None, grad_norm=None):
        if not finite:
            self.total_skips += 1
            self.consecutive_skips += 1
            self.journal.event(
                "nonfinite_grad", step=int(step),
                grad_norm=_jsonable(grad_norm), loss=_jsonable(loss),
                consecutive=self.consecutive_skips,
                total_skips=self.total_skips, consumer=self.consumer)
            if self.consecutive_skips >= self.cfg.max_consecutive_skips:
                self.reason = (f"{self.consecutive_skips} consecutive "
                               "non-finite gradient steps")
                return "diverged"
            return "skip"
        self.consecutive_skips = 0
        if loss is not None and np.isfinite(loss):
            verdict = self._observe_loss(step, float(loss))
            if verdict is not None:
                return verdict
        return "ok"

    def _observe_loss(self, step, loss):
        # the window only accumulates NON-spiking losses: a runaway loss
        # must not drag the median up under itself and mute the alarm.
        # the arming threshold is capped at the window itself — the
        # deque can never hold more than spike_window entries, so an
        # uncapped >= 8 gate would silently disarm tiny windows
        if len(self._losses) >= min(self.cfg.spike_window,
                                    max(8, self.cfg.spike_window // 4)):
            median = float(np.median(self._losses))
            if abs(loss) > self.cfg.spike_factor * max(abs(median), 1e-12):
                self._spike_run += 1
                self.journal.event(
                    "loss_spike", step=int(step), loss=loss,
                    rolling_median=median, run=self._spike_run,
                    consumer=self.consumer)
                if self._spike_run >= self.cfg.spike_steps:
                    self.reason = (f"loss {loss:g} above "
                                   f"{self.cfg.spike_factor:g}x rolling "
                                   f"median {median:g} for "
                                   f"{self._spike_run} consecutive steps")
                    return "diverged"
                return "ok"     # spiking: counted, excluded from window
        self._spike_run = 0
        self._losses.append(loss)
        return None

    def observe_window(self, start_step, finites, losses=None, norms=None,
                       collapse_runs=False):
        """Fold a ``run_steps`` window (per-step arrays) into the monitor
        sequentially. Returns the first non-"ok" verdict with its step,
        or ``("ok", last_step)``.

        ``collapse_runs=True`` is the fp16 multi-step contract: the loss
        scale is one traced input frozen for the whole scanned window,
        so every step after the first overflow of a run re-decided
        under a scale the scaler never got to halve. Such a run counts
        ONCE against the consecutive-skip budget; its follow-on steps
        are still journaled (``stale_scale: true`` — they really were
        skipped in-program, and ``guard_report`` counts records)
        but cannot stack up to a spurious :class:`TrainingDiverged`
        that the per-step path would have self-healed with one or two
        halvings."""
        finites = list(finites)
        verdict, at = "ok", int(start_step) + len(finites) - 1
        stale = (stale_scale_runs(finites) if collapse_runs
                 else [False] * len(finites))
        run_pos = 0     # in-program position within the current skip run
        for i, f in enumerate(finites):
            step = int(start_step) + i
            bad = not bool(f)
            if stale[i]:
                run_pos += 1
                self.total_skips += 1
                self.journal.event(
                    "nonfinite_grad", step=step,
                    grad_norm=None if norms is None
                    else _jsonable(norms[i]),
                    loss=None if losses is None else _jsonable(losses[i]),
                    # the run's true in-program length, NOT the collapsed
                    # budget counter — guard_report's worst-consecutive-skips
                    # reads this field
                    consecutive=run_pos, total_skips=self.total_skips,
                    stale_scale=True, consumer=self.consumer)
                if verdict == "ok":
                    verdict, at = "skip", step
                continue
            run_pos = 1 if bad else 0
            v = self.observe(
                step, bool(f),
                loss=None if losses is None else float(losses[i]),
                grad_norm=None if norms is None else float(norms[i]))
            if v == "diverged":
                return "diverged", step
            if v == "skip" and verdict == "ok":
                verdict, at = "skip", step
        return verdict, at

    def reset_stats(self):
        """Clear trajectory state (post-rollback: the restored world has
        a different loss scale/landscape). The rollback counter is NOT
        reset — it is the bounded-retry budget."""
        self.consecutive_skips = 0
        self._losses.clear()
        self._spike_run = 0
        self.reason = None


def _jsonable(v):
    if v is None:
        return None
    f = float(v)
    return f if np.isfinite(f) else repr(f)


def journal_scaler_only_skip(step, grad_norm, loss, consumer,
                             total_skips=None):
    """The one constructor of the fp16-only skip record (scaler active, no
    :class:`GuardConfig`): guard_report's skip accounting must not depend on
    opting into budgets/rollback, and the record schema must not fork
    across the trainer paths that emit it. ``total_skips`` is optional —
    the fused trainers carry their total in-program and won't pay a
    fetch just to journal it."""
    rec = {"step": int(step), "grad_norm": _jsonable(grad_norm),
           "loss": _jsonable(loss), "scaler_only": True,
           "consumer": consumer}
    if total_skips is not None:
        rec["total_skips"] = int(total_skips)
    get_journal().event("nonfinite_grad", **rec)


class _BackoffScheduler:
    """LR-scheduler wrapper applying the rollback backoff factor on top
    of the wrapped schedule (set_learning_rate is refused when a
    scheduler is installed, so the wrap is the only safe hook)."""

    def __init__(self, base, factor):
        self.base = base
        self.factor = float(factor)
        # mirror the attribute optimizer.__init__ maintains on schedulers
        self.base_lr = getattr(base, "base_lr", None)

    def __call__(self, num_update):
        return self.base(num_update) * self.factor


def set_cumulative_lr_backoff(optimizer, cumulative):
    """Bring the optimizer's effective LR to ``cumulative ×`` its
    checkpoint baseline, regardless of what the restore did to the
    optimizer object.

    The two trainer families differ here: the fused trainers' optimizer
    object SURVIVES a restore (any earlier backoff is still in force),
    while the gluon ``Trainer.load_states`` REPLACES the optimizer with
    the checkpoint's pickled copy — a fresh object at the checkpoint's
    LR, which would silently erase rollback #1's backoff when rollback
    #2 applies its single factor. The carried marker
    (``_guard_lr_backoff``, pickled with the optimizer so it always
    describes the LR it travels with) records how much backoff the
    CURRENT object already carries; applying ``cumulative / carried``
    lands both families on the same compounded trajectory."""
    if optimizer.lr_scheduler is not None:
        sched = optimizer.lr_scheduler
        if isinstance(sched, _BackoffScheduler):
            sched.factor = float(cumulative)
        else:
            optimizer.lr_scheduler = _BackoffScheduler(sched, cumulative)
        return float(cumulative)
    carried = getattr(optimizer, "_guard_lr_backoff", 1.0)
    optimizer.set_learning_rate(
        optimizer.learning_rate * float(cumulative) / carried)
    optimizer._guard_lr_backoff = float(cumulative)
    return float(cumulative)


def handle_divergence(monitor, step, restore_fn, optimizer,
                      on_restored=None):
    """The rollback protocol, shared by every trainer path.

    With a checkpoint root configured and budget left: restore the
    newest CRC-valid committed step (``restore_fn`` — the trainer's own
    ``restore``), apply the LR backoff, journal a structured
    ``divergence_rollback``, reset the monitor's trajectory stats, and
    return the restored step so training resumes. Otherwise raise
    :class:`TrainingDiverged`. A restore that itself fails (no valid
    checkpoint) chains into the divergence error — the caller must
    never silently keep training on garbage."""
    cfg = monitor.cfg
    reason = monitor.reason or "anomaly budget exhausted"
    if cfg.ckpt_root is None or monitor.rollbacks >= cfg.max_rollbacks:
        raise TrainingDiverged(step, reason,
                               consecutive_skips=monitor.consecutive_skips,
                               rollbacks=monitor.rollbacks)
    try:
        restored = restore_fn()
    except MXNetError as e:
        raise TrainingDiverged(
            step, f"{reason}; rollback failed: {e}",
            consecutive_skips=monitor.consecutive_skips,
            rollbacks=monitor.rollbacks) from e
    monitor.rollbacks += 1
    # ``optimizer`` may be a zero-arg callable: a restore can REPLACE the
    # trainer's optimizer object (gluon Trainer.load_states does), and
    # the backoff must land on the restored one — compounded across
    # rollbacks even when the restore reset it (set_cumulative_lr_backoff
    # has the full story). A list/tuple backs off every member
    # (SequentialModule chains modules with separate optimizers).
    opt = optimizer() if callable(optimizer) else optimizer
    opts = list(opt) if isinstance(opt, (list, tuple)) else [opt]
    backoff = None
    for o in opts:
        if o is None:
            continue
        b = set_cumulative_lr_backoff(o, cfg.lr_backoff ** monitor.rollbacks)
        backoff = b if backoff is None else backoff
    monitor.journal.event(
        "divergence_rollback", step=int(step),
        restored_step=int(restored) if restored is not None else None,
        reason=reason, lr_backoff=backoff, rollback=monitor.rollbacks,
        max_rollbacks=cfg.max_rollbacks, consumer=monitor.consumer)
    monitor.reset_stats()
    if on_restored is not None:
        on_restored(restored)
    return restored
