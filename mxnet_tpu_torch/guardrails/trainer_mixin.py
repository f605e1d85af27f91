"""Host-side guard bookkeeping of the one-program trainer (counterpart
of ``mxnet_tpu/guardrails/trainer_mixin.py``).

The per-step scaler and monitor feed, a ``run_steps`` window's
aftermath (with the stale-scale run collapse), divergence handling and
the in-step skip counters. A trainer supplies its consumer tag
(``_guard_consumer``) and fresh counters on its device
(``_reinit_guard_state``).

Host attributes the mixin expects: ``_scaler``, ``_guard_cfg``,
``_monitor``, ``_guard_state``, ``_skipped_offset``, ``_optimizer``,
``_num_update`` and ``restore(ckpt_dir)``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..diagnostics.journal import get_journal
from . import fused
from .monitor import (handle_divergence, journal_scaler_only_skip,
                      stale_scale_runs)

__all__ = ["GuardedTrainerMixin"]


class GuardedTrainerMixin:
    """Guard bookkeeping of the trainers whose whole step is one
    program."""

    _guard_consumer = "trainer"

    def _reinit_guard_state(self):
        """Fresh in-step counters on this trainer's device."""
        raise NotImplementedError

    def _validate_guard_mode(self):
        """Refuse ``mode="deferred"`` with an fp16 loss scaler: the scale
        is a host input updated from every step's flag, so the per-step
        reads deferred mode promises to avoid would happen anyway while
        the monitor is never fed."""
        cfg = self._guard_cfg
        if (cfg is not None and cfg.mode == "deferred"
                and self._scaler is not None):
            raise MXNetError(
                "GuardConfig(mode='deferred') cannot be combined with "
                "fp16 dynamic loss scaling — the scale update needs "
                "every step's flag on the host; use mode='step' "
                "(docs/guardrails.md)")

    @staticmethod
    def _read_stats(stats):
        """One ``host_fetch`` of a step's or a window's rows of (loss,
        finite flag, global norm), made on the device by the step:
        (losses, flags, norms) as host lists in step order."""
        flat = fused.host_fetch(stats)[0]
        return flat[0::3], [bool(f) for f in flat[1::3]], flat[2::3]

    # -- per step -------------------------------------------------------------
    def _after_step(self, t, stats):
        """Feed the scaler and the monitor from the step's own (3,) row
        of (loss, finite flag, global norm), with one host read. In
        ``deferred`` mode (and with neither a guard nor a scaler)
        nothing is read: the skip counters accumulate in the step and
        ``guard_poll`` reads them."""
        cfg = self._guard_cfg
        eager = (self._scaler is not None
                 or (cfg is not None and cfg.mode == "step"))
        if not eager:
            return
        (loss_v,), (ok,), (gn,) = self._read_stats(stats)
        if self._scaler is not None:
            self._scaler.update_scale(not ok)
        if cfg is not None and cfg.mode == "step":
            verdict = self._monitor.observe(t, ok, loss=loss_v,
                                            grad_norm=gn)
            if verdict == "diverged":
                self._handle_divergence(t)
        elif not ok:
            self._journal_scaler_only_skip(t, loss_v, gn)

    # -- run_steps windows ----------------------------------------------------
    def _after_run_steps(self, start_t, stats):
        """A ``run_steps`` window's bookkeeping: one host read of its
        (n, 3) rows of (loss, finite flag, global norm), fed to the
        scaler and the monitor in step order. The loss scale was frozen
        for the window, so a run of consecutive overflows was decided
        under one stale scale: the scale halves once per run and the skip
        budget is charged once per run
        (``AnomalyMonitor.observe_window(collapse_runs=True)``)."""
        cfg = self._guard_cfg
        eager = (self._scaler is not None
                 or (cfg is not None and cfg.mode == "step"))
        if not eager:
            return
        loss_a, fin_a, gn_a = self._read_stats(stats)
        if self._scaler is not None:
            for f, stale in zip(fin_a, stale_scale_runs(fin_a)):
                if not stale:
                    self._scaler.update_scale(not f)
        if cfg is not None and cfg.mode == "step":
            verdict, at = self._monitor.observe_window(
                start_t, fin_a, losses=loss_a, norms=gn_a,
                collapse_runs=self._scaler is not None)
            if verdict == "diverged":
                self._handle_divergence(at)
        else:
            for i, f in enumerate(fin_a):
                if not f:
                    self._journal_scaler_only_skip(
                        int(start_t) + i, loss_a[i], gn_a[i])

    def _journal_scaler_only_skip(self, t, loss_v, gn):
        journal_scaler_only_skip(t, gn, loss_v, self._guard_consumer)

    # -- divergence -----------------------------------------------------------
    def _handle_divergence(self, t):
        restored = handle_divergence(
            self._monitor, t,
            restore_fn=lambda: self.restore(self._guard_cfg.ckpt_root),
            optimizer=self._optimizer)
        # the counters belong to the abandoned trajectory: bank the total
        # and zero them in place (the captured programs update these
        # very tensors)
        self._skipped_offset += int(fused.host_fetch(
            self._guard_state[0])[0])
        with torch.no_grad():
            for c in self._guard_state:
                c.zero_()
        return restored

    # -- counters -------------------------------------------------------------
    @property
    def skipped_steps(self):
        """Steps skipped on a non-finite gradient so far (one host read
        of the in-step counter)."""
        if self._guard_state is None:
            return self._skipped_offset
        return self._skipped_offset + int(
            fused.host_fetch(self._guard_state[0])[0])

    def guard_poll(self):
        """Deferred mode's poll: read the in-step counters once and return
        ``(total_skips, consecutive_skips)``; journals a ``guard_poll``
        record."""
        if self._guard_state is None:
            return (self._skipped_offset, 0)
        total, consec = fused.host_fetch(torch.stack(self._guard_state))[0]
        total = int(total) + self._skipped_offset
        get_journal().event("guard_poll", step=int(self._num_update),
                            total_skips=total, consecutive=int(consec),
                            consumer=self._guard_consumer)
        return (total, int(consec))
