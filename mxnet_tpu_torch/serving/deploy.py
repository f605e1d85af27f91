"""Canary-gated deployment controller — the guarded train→serve loop
(counterpart of ``mxnet_tpu/serving/deploy.py``).

Trainers commit CRC-valid steps (``resilience.commit``), ``ParamStore``
hot-reloads them, the pool rolls restarts and the router stamps every
response with its ``params_step``. :class:`DeployController` promotes a
new commit to the whole pool only behind a canary:

1. **canary**: the new step is pinned onto exactly ``canary_k``
   replicas (``ParamStore.pin_step`` and the server's pin lane copy it
   into the live tensors between batches, so the captured graphs serve
   it; ``restart=True`` restarts each canary instead, the pool's
   draining restart). Every other replica is pinned to the old step
   first, so nothing outside the canary set adopts the new root
   mid-deploy.
2. **gate**: every ``window_s`` the controller compares canary and
   control traffic from the router's deploy tap (fresh per-arm p99s,
   served and failure counts), the router's shed counters, the ledger
   (a canary that loses its heartbeat or opens its breaker is an
   immediate breach) and sampled output parity: a fraction of
   control-served requests is mirrored onto a canary replica and the
   answers compared within ``mirror_rtol``/``mirror_atol``
   (``deploy_mirror_mismatch``).
3. **promote / rollback**: ``promote_after`` consecutive clean gates
   move the other replicas forward; any breach re-pins the canaries to
   the old step, and the pins stay installed so a rolled-back replica
   cannot re-adopt the bad root at its next poll.

Every transition (``deploy_start``/``canary_up``/``gate_eval``/
``promote``/``rollback``/``deploy_done``) is journaled under one
``deploy`` trace span. A ``pool.reload()`` or a second ``deploy()``
during a live canary raises :class:`~.pool.DeployInProgress`.

The controller drives the pool's replicas and the router; it runs
nothing on a device itself, so the card is wherever the replicas'
servers run (``cuda:0`` unless they were built with ``ctx=mx.cpu()``).
"""
from __future__ import annotations

import os
import time
from collections import Counter
from dataclasses import dataclass, field

from ..base import MXNetError
from ..diagnostics.journal import get_journal
from ..observability import trace as _trace
from ..resilience import commit as _commit
from ..resilience.retry import _env_float, _env_int
from .pool import _wait_for

__all__ = ["DeployConfig", "DeployController"]


@dataclass
class DeployConfig:
    """Canary-deployment knobs (the ``MXNET_TPU_DEPLOY_*`` environment
    variables set the defaults)."""

    canary_k: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_DEPLOY_CANARY_K", 1))
    window_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_WINDOW_S", 2.0))       # gate-eval cadence
    promote_after: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_DEPLOY_PROMOTE_AFTER", 3))    # consecutive clean gates
    min_samples: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_DEPLOY_MIN_SAMPLES", 20))     # per arm, before verdicts
    p99_ratio: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_P99_RATIO", 2.0))      # canary/control ceiling
    p99_floor_ms: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_P99_FLOOR_MS", 50.0))  # ignore sub-floor deltas
    error_delta: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_ERROR_DELTA", 0.05))   # failure-rate ceiling
    shed_ceiling: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_SHED_CEILING", 0.2))   # window shed-rate ceiling
    mirror_fraction: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_MIRROR_FRACTION", 0.25))
    mirror_rtol: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_MIRROR_RTOL", 1e-5))
    mirror_atol: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_MIRROR_ATOL", 1e-6))
    mismatch_budget: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_DEPLOY_MISMATCH_BUDGET", 0))  # > budget mismatches trip
    rollback_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_ROLLBACK_S", 30.0))    # rollback deadline budget
    deadline_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_DEPLOY_DEADLINE_S", 600.0))   # whole-deploy bound; a
                                                 # gate stuck "insufficient"
                                                 # rolls back, never hangs
    restart: bool = False      # True: draining restart per canary (the
                               # reload(surge=k) mechanics) instead of the
                               # in-place pin lane
    poll_s: float = 0.05

    def __post_init__(self):
        if self.canary_k < 1:
            raise MXNetError("deploy canary_k must be >= 1")
        if self.window_s <= 0:
            raise MXNetError("deploy window_s must be > 0")
        if self.promote_after < 1:
            raise MXNetError("deploy promote_after must be >= 1")
        if not 0.0 <= self.mirror_fraction <= 1.0:
            raise MXNetError("deploy mirror_fraction must be in [0, 1]")
        if self.rollback_s <= 0:
            raise MXNetError("deploy rollback_s must be > 0")
        if self.deadline_s <= self.window_s:
            raise MXNetError(
                f"deploy deadline_s ({self.deadline_s:g}) must exceed "
                f"window_s ({self.window_s:g}) — the deadline must admit "
                "at least one gate evaluation")


def _newest_valid_step(root):
    """Newest committed step that passes CRC validation right now, or
    None.  Mirrors ParamStore's skip-don't-die posture: a torn newest
    step must not wedge a deploy onto it."""
    for step in sorted(_commit.committed_steps(root), reverse=True):
        try:
            _commit.validate_step(root, step)
            return step
        except ValueError:
            continue
    return None


class DeployController:
    """Drives one :class:`~.pool.ReplicaPool` + :class:`~.router.Router`
    pair through canary → gate → promote/rollback for one commit root.
    ``deploy()`` blocks until the terminal state and returns the result
    document; it is safe to call again afterwards (one deploy at a
    time — a concurrent call raises ``DeployInProgress``)."""

    def __init__(self, pool, router, root, config=None):
        self.pool = pool
        self.router = router
        self.root = str(root)
        self.cfg = config or DeployConfig()
        self._tag = f"deploy-{os.urandom(3).hex()}"

    # -- step resolution -------------------------------------------------
    def _fleet_step(self):
        """The step the fleet currently serves (the rollback target):
        the most common non-None beacon step, larger step on ties."""
        steps = [s.params_step for s in self.pool.view()
                 if s.params_step is not None]
        if not steps:
            return None
        ranked = Counter(steps).most_common()
        top = ranked[0][1]
        return max(st for st, n in ranked if n == top)

    # -- the state machine -----------------------------------------------
    def deploy(self, step=None) -> dict:
        """Run one full deployment; returns
        ``{"result": "promoted"|"rolled_back"|"noop", ...}``.  Raises
        ``DeployInProgress`` when another deploy owns the pool, and
        ``MXNetError`` when there is nothing valid to deploy or no
        served baseline to roll back to."""
        cfg = self.cfg
        new_step = _newest_valid_step(self.root) if step is None \
            else int(step)
        if new_step is None:
            raise MXNetError(
                f"nothing to deploy: no CRC-valid committed step under "
                f"{self.root!r}")
        if step is not None:
            _commit.validate_step(self.root, new_step)  # fail fast, loudly
        old_step = self._fleet_step()
        if old_step is None:
            raise MXNetError(
                "cannot canary: no replica advertises a served "
                "params_step — the fleet needs a committed baseline to "
                "roll back to before a gated deploy makes sense")
        rids = sorted(self.pool.replicas)
        if cfg.canary_k >= len(rids):
            raise MXNetError(
                f"canary_k ({cfg.canary_k}) must leave at least one "
                f"control replica (pool has {len(rids)})")
        if new_step == old_step:
            get_journal().event("deploy_done", result="noop",
                                from_step=old_step, to_step=new_step)
            return {"result": "noop", "from_step": old_step,
                    "to_step": new_step}
        self.pool.deploy_acquire(self._tag)     # DeployInProgress if held
        try:
            with _trace.span("deploy", root=self.root,
                             from_step=old_step, to_step=new_step):
                return self._run(rids, old_step, new_step)
        finally:
            self.router.clear_deploy()
            self.pool.deploy_release(self._tag)

    def _run(self, rids, old_step, new_step):
        cfg = self.cfg
        j = get_journal()
        canary = rids[:cfg.canary_k]
        control = rids[cfg.canary_k:]
        j.event("deploy_start", root=self.root, from_step=old_step,
                to_step=new_step, canary=canary, control=control,
                window_s=cfg.window_s, promote_after=cfg.promote_after,
                mirror_fraction=cfg.mirror_fraction,
                restart=cfg.restart, tag=self._tag)
        t_deploy = time.monotonic()
        # control pins FIRST: once these land, nothing outside the
        # canary set can adopt the new root — the blast-radius bound
        for rid in control:
            self.pool.pin_step(rid, old_step)
        for rid in canary:
            self.pool.pin_step(rid, new_step)
            if cfg.restart:
                self.pool.restart(rid, deadline_s=cfg.rollback_s)
        canary_set = set(canary)
        up = _wait_for(
            lambda: all(s.params_step == new_step
                        for s in self.pool.view() if s.id in canary_set),
            cfg.deadline_s / 2.0, cfg.poll_s)
        if not up:
            # the new step pinned but never became the served version
            # (failed to apply: architecture drift, torn read) — there
            # is no canary to evaluate, only a version to back out
            return self._rollback(
                canary, control, old_step, new_step,
                reason="canary_startup",
                detail="canary replicas never converged on the new step",
                gate_evals=0, t_deploy=t_deploy)
        tap = self.router.set_deploy(
            canary, mirror_fraction=cfg.mirror_fraction,
            rtol=cfg.mirror_rtol, atol=cfg.mirror_atol)
        j.event("canary_up", replicas=canary, step=new_step,
                up_ms=round((time.monotonic() - t_deploy) * 1000.0, 1))
        base = self.router.stats()              # shed-window baseline
        deadline = time.monotonic() + cfg.deadline_s
        passes = evals = 0
        breach = None
        while time.monotonic() < deadline:      # G13: bounded gate loop
            time.sleep(cfg.window_s)
            evals += 1
            verdict, metrics = self._evaluate(canary_set, base)
            j.event("gate_eval", n=evals, verdict=verdict["verdict"],
                    reasons=verdict["reasons"], **metrics)
            self._mirror_gauges(evals, verdict["verdict"])
            if verdict["verdict"] == "breach":
                breach = verdict
                break
            if verdict["verdict"] == "pass":
                passes += 1
                if passes >= cfg.promote_after:
                    break
            # "insufficient" neither passes nor resets: low traffic is
            # not evidence either way — the deploy deadline bounds it
        if breach is not None:
            return self._rollback(
                canary, control, old_step, new_step,
                reason=breach["reasons"][0],
                detail=breach, gate_evals=evals, t_deploy=t_deploy)
        if passes < cfg.promote_after:
            # deadline expired without enough clean gates: conservative
            # outcome is the old version, never a coin-flip promote
            return self._rollback(
                canary, control, old_step, new_step,
                reason="deploy_deadline",
                detail=f"only {passes} clean gates in {cfg.deadline_s:g}s",
                gate_evals=evals, t_deploy=t_deploy)
        return self._promote(rids, canary, control, old_step, new_step,
                             evals, t_deploy)

    # -- gate evaluation -------------------------------------------------
    def _evaluate(self, canary_set, base):
        """One gate evaluation: returns ``({verdict, reasons}, metrics)``
        where verdict is ``pass`` / ``insufficient`` / ``breach``.
        Hard signals (canary lost, breaker open) breach immediately even
        before the arms reach ``min_samples``."""
        cfg = self.cfg
        st = self.router.stats()
        dep = st.get("deploy") or {}
        reasons = []
        # hard signals: the ledger + breaker already decided this canary
        # is unhealthy — no statistics needed
        for s in self.pool.view():
            if s.id in canary_set and not s.alive:
                reasons.append("canary_lost")
                break
        for rid in canary_set:
            if (st["replicas"].get(rid) or {}).get("breaker") == "open":
                reasons.append("canary_breaker_open")
                break
        # output parity: mirrored control requests answered differently
        if dep.get("mirror_mismatch", 0) > cfg.mismatch_budget:
            reasons.append("parity")
        # window shed rate (router-level, both arms: a deploy that
        # starves the fleet's capacity floor is a regression even if
        # the canary itself looks healthy)
        d_req = st["requests"] - base["requests"]
        d_shed = (st["shed"] + st["no_capacity"]
                  - base["shed"] - base["no_capacity"])
        shed_rate = (d_shed / d_req) if d_req > 0 else 0.0
        if d_req > 0 and shed_rate > cfg.shed_ceiling:
            reasons.append("shed_rate")
        c_n = dep.get("canary_count", 0)
        k_n = dep.get("control_count", 0)
        c_p99 = dep.get("canary_p99_ms")
        k_p99 = dep.get("control_p99_ms")
        sufficient = c_n >= cfg.min_samples and k_n >= cfg.min_samples
        if sufficient:
            if c_p99 is not None and k_p99 is not None \
                    and c_p99 > k_p99 * cfg.p99_ratio \
                    and c_p99 > k_p99 + cfg.p99_floor_ms:
                reasons.append("p99")
            served = dep.get("served", {})
            fails = dep.get("failures", {})

            def rate(arm):
                n = served.get(arm, 0) + fails.get(arm, 0)
                return (fails.get(arm, 0) / n) if n else 0.0

            if rate("canary") - rate("control") > cfg.error_delta:
                reasons.append("error_rate")
        metrics = {
            "canary_p99_ms": c_p99, "control_p99_ms": k_p99,
            "canary_count": c_n, "control_count": k_n,
            "canary_served": dep.get("served", {}).get("canary", 0),
            "control_served": dep.get("served", {}).get("control", 0),
            "canary_failures": dep.get("failures", {}).get("canary", 0),
            "control_failures": dep.get("failures", {}).get("control", 0),
            "mirrors": dep.get("mirrors", 0),
            "mirror_mismatch": dep.get("mirror_mismatch", 0),
            "mirror_errors": dep.get("mirror_errors", 0),
            "shed_rate": round(shed_rate, 4)}
        if reasons:
            verdict = "breach"
        elif not sufficient:
            verdict = "insufficient"
        else:
            verdict = "pass"
        return {"verdict": verdict, "reasons": reasons}, metrics

    # -- terminal transitions --------------------------------------------
    def _promote(self, rids, canary, control, old_step, new_step, evals,
                 t_deploy):
        cfg = self.cfg
        j = get_journal()
        j.event("promote", step=new_step, from_step=old_step,
                replicas=control, gate_evals=evals)
        # gates are over: stop tagging/mirroring before the control arm
        # starts moving, or the tap would compare a fleet against itself
        self.router.clear_deploy()
        for rid in control:
            self.pool.pin_step(rid, new_step)
        converged = _wait_for(
            lambda: all(s.params_step == new_step
                        for s in self.pool.view() if s.alive),
            cfg.rollback_s, cfg.poll_s)
        if not converged:
            # rollback-during-promote: part of the fleet refused the new
            # step — a half-promoted fleet is the one state the version
            # contract cannot tolerate, so everyone goes back to old
            return self._rollback(
                rids, [], old_step, new_step, reason="promote_stall",
                detail="control replicas never converged on the new step",
                gate_evals=evals, t_deploy=t_deploy)
        for rid in rids:
            self.pool.pin_step(rid, None)      # resume newest-wins polling
        doc = {"result": "promoted", "from_step": old_step,
               "to_step": new_step, "canary": canary,
               "gate_evals": evals,
               "deploy_ms": round((time.monotonic() - t_deploy) * 1000.0,
                                  1)}
        j.event("deploy_done", **doc)
        self._done_gauges("promoted", evals)
        return doc

    def _rollback(self, canary, control, old_step, new_step, reason,
                  detail, gate_evals, t_deploy):
        """Re-pin every affected replica to the old step and wait (within
        the rollback deadline budget) for the live versions to converge.
        The pins STAY installed: the bad root remains committed on disk,
        and an unpinned store would re-adopt it on its next poll."""
        cfg = self.cfg
        j = get_journal()
        t0 = time.monotonic()
        j.event("rollback", reason=reason, detail=str(detail)[:300],
                from_step=new_step, to_step=old_step,
                replicas=list(canary), gate_evals=gate_evals)
        self.router.clear_deploy()             # stop mirroring first
        for rid in canary:
            self.pool.pin_step(rid, old_step)
        canary_set = set(canary)
        converged = _wait_for(
            lambda: all(s.params_step == old_step
                        for s in self.pool.view()
                        if s.id in canary_set and s.alive),
            cfg.rollback_s, cfg.poll_s)
        # a dead canary (SIGKILL) converges later: its respawn starts
        # pinned to old_step through the handle's remembered pin
        doc = {"result": "rolled_back", "reason": reason,
               "from_step": old_step, "to_step": new_step,
               "canary": list(canary), "gate_evals": gate_evals,
               "converged": bool(converged),
               "rollback_ms": round((time.monotonic() - t0) * 1000.0, 1),
               "deploy_ms": round((time.monotonic() - t_deploy) * 1000.0,
                                  1)}
        j.event("deploy_done", **doc)
        self._done_gauges("rolled_back", gate_evals)
        return doc

    # -- metrics wiring (observability/metrics.py) -----------------------
    _STATE_CODE = {"canary": 1, "promoted": 2, "rolled_back": 3}

    def _mirror_gauges(self, evals, verdict):
        from ..observability import metrics as _m
        reg = _m.default_registry()
        reg.gauge("mxnet_tpu_deploy_state",
                  "deploy state (0 idle, 1 canary, 2 promoted, "
                  "3 rolled back)").set(self._STATE_CODE["canary"])
        reg.gauge("mxnet_tpu_deploy_gate_evals",
                  "gate evaluations this deployment").set(evals)
        if verdict == "breach":
            reg.counter("mxnet_tpu_deploy_gate_breaches_total",
                        "gate breaches across deployments").inc()

    def _done_gauges(self, result, evals):
        from ..observability import metrics as _m
        reg = _m.default_registry()
        reg.gauge("mxnet_tpu_deploy_state",
                  "deploy state (0 idle, 1 canary, 2 promoted, "
                  "3 rolled back)").set(self._STATE_CODE[result])
        reg.gauge("mxnet_tpu_deploy_gate_evals",
                  "gate evaluations this deployment").set(evals)
        reg.counter("mxnet_tpu_deploy_total",
                    "terminal deployments by result",
                    ("result",)).labels(result=result).inc()
