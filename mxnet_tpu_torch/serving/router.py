"""Health-routed front door — placement, retries, hedging, breakers
(counterpart of ``mxnet_tpu/serving/router.py``).

The router multiplexes requests across a :class:`~.pool.ReplicaPool`.
Its placement decision is derived ONLY from the pool's heartbeat ledger
(:meth:`ReplicaPool.view` — live + ready, least queue depth), so every
router thread (and any other reader of the same ledger) sees the same
picture; the only router-local overlay is the per-replica circuit
breaker, which exists precisely to react FASTER than the heartbeat
deadline when a replica starts failing requests.

Per-request robustness budget:

- **deadline-scoped retries** — a retryable failure (transport error,
  stopped/overloaded replica, predictor fault) moves to a different
  replica with ``resilience.retry`` backoff bounds, always inside the
  request's own deadline; when the budget runs out the caller gets
  ``DeadlineExceeded(stage="router_budget")`` naming the tier that
  acted, never a silent hang;
- **tail-latency hedging** (optional) — if the first attempt hasn't
  answered after a p99-derived delay, a second attempt starts on a
  different replica; first response wins, the loser is cancelled at
  dequeue (in-process replicas) or its reply discarded (subprocess);
- **circuit breaker per replica** — K consecutive failures or a
  heartbeat stall opens the breaker (requests stop routing there);
  after a cooldown it goes half-open and ONE probe request re-admits
  (success → closed) or re-opens it.  Every transition is journaled
  (``router_breaker``);
- **graceful degradation** — when live capacity falls below the
  configured floor, the router sheds by admission class (lowest
  priority first) instead of failing everyone: ``ServerOverloaded``
  carries the tier that acted.

Decode streams (:meth:`Router.decode_call`) ride the same placement,
retries and breakers without hedging. The canary tap (``set_deploy``)
tags responses and mirrors a sample of control traffic onto a canary.

Tracing: each call is a ``router_request`` span (``router_decode`` for a
stream) and each attempt a ``router_attempt`` span under it; a hedged
attempt runs in a ``router_hedge_arm`` span on its own thread and a
mirrored probe in a ``deploy_mirror`` span, both re-anchored under the
request. A subprocess replica's wire frame carries the attempt's
context, so the worker's spans join the same trace.

Metric families (``Router.metrics_text``): ``mxnet_tpu_router_events``,
``mxnet_tpu_router_breaker_state``, ``mxnet_tpu_router_attempts_total``,
``mxnet_tpu_router_replica_p99_ms``, and during a deployment
``mxnet_tpu_deploy_arm`` and ``mxnet_tpu_deploy_mirrors``.

Not ported yet (ROADMAP Queue 1 item 5): tuned tables (the reference's
``_apply_tuned_router``; ``RouterConfig``'s own defaults apply) and the
``MXNET_TPU_SERVING_DEADLINE_MS`` default.
"""
from __future__ import annotations

import itertools
import os
import queue as _queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ..diagnostics.journal import get_journal
from ..observability import trace as _trace
from ..observability.metrics import LatencySummary
from ..resilience import atomic as _atomic
from ..resilience.retry import backoff_delays
from .batcher import DeadlineExceeded, RequestError, ServerOverloaded

__all__ = ["Router", "RouterConfig", "RouterResponse"]


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class RouterConfig:
    """Front-door knobs (``MXNET_TPU_POOL_*`` env vars set defaults)."""

    default_deadline_ms: float = 2000.0
    retries: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_POOL_RETRIES", 2))
    retry_base_s: float = 0.02               # resilience.retry bounds
    retry_max_s: float = 0.5
    retry_jitter: float = 0.5
    hedge_ms: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_POOL_HEDGE_MS", 0.0))     # <= 0 disables hedging
    hedge_p99_factor: float = 1.0            # delay = max(hedge_ms, p99*f)
    hedge_min_samples: int = 20              # p99 trustworthy after this
    breaker_k: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_POOL_BREAKER_K", 3))
    breaker_cooldown_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_POOL_BREAKER_COOLDOWN_S", 5.0))
    capacity_floor: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_POOL_CAPACITY_FLOOR", 0.0))   # 0 disables degradation


CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_BREAKER_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class _Breaker:
    """Per-replica failure bookkeeping.  ``closed`` routes normally;
    ``open`` routes nothing until the cooldown passes; ``half_open``
    admits exactly ONE probe request whose outcome decides re-admission
    (success → closed) or another cooldown (failure → open)."""

    __slots__ = ("state", "failures", "opened_t", "probing", "reason")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.opened_t = None
        self.probing = False
        self.reason = None


class RouterResponse:
    """One routed result plus its provenance: which replica answered,
    which checkpoint step served it (the rolling-reload version stamp),
    how many attempts it took, and whether a hedge fired.  During a
    canary deployment ``deploy_role`` tags the placement arm ("canary"
    or "control"); None outside a deploy."""

    __slots__ = ("value", "replica", "params_step", "attempts", "hedged",
                 "latency_ms", "deploy_role")

    def __init__(self, value, replica, params_step, attempts, hedged,
                 latency_ms, deploy_role=None):
        self.value = value
        self.replica = replica
        self.params_step = params_step
        self.attempts = attempts
        self.hedged = hedged
        self.latency_ms = latency_ms
        self.deploy_role = deploy_role


class _DeployTap:
    """Canary/control bookkeeping for ONE deployment, installed by the
    DeployController via :meth:`Router.set_deploy` and torn down on
    promote/rollback.  Counters are guarded by the router lock; the two
    latency summaries are internally thread-safe.  The tap is a fresh
    window — it observes only traffic DURING the deploy, so the gate
    comparison is live canary-vs-control, not polluted by pre-deploy
    history."""

    __slots__ = ("canary", "mirror_every", "rtol", "atol", "_n",
                 "lat_canary", "lat_control", "served", "failures",
                 "mirrors", "mirror_mismatch", "mirror_errors",
                 "mirror_skipped", "mirror_inflight", "max_inflight")

    def __init__(self, canary, mirror_fraction, rtol, atol,
                 max_inflight=4):
        self.canary = frozenset(map(str, canary))
        # deterministic 1-in-N sampling (no RNG on the request path);
        # fraction <= 0 disables mirroring
        self.mirror_every = (0 if mirror_fraction <= 0
                             else max(int(round(1.0 / mirror_fraction)), 1))
        self.rtol = float(rtol)
        self.atol = float(atol)
        self._n = 0
        self.lat_canary = LatencySummary("deploy_canary_ms")
        self.lat_control = LatencySummary("deploy_control_ms")
        self.served = {"canary": 0, "control": 0}
        self.failures = {"canary": 0, "control": 0}
        self.mirrors = 0
        self.mirror_mismatch = 0
        self.mirror_errors = 0
        self.mirror_skipped = 0
        self.mirror_inflight = 0
        self.max_inflight = int(max_inflight)   # bounded mirror threads

    def role(self, rid) -> str:
        return "canary" if str(rid) in self.canary else "control"


class Router:
    """The front door over one :class:`~.pool.ReplicaPool` (thread-safe;
    call :meth:`predict` / :meth:`call` from any number of client
    threads)."""

    def __init__(self, pool, config=None):
        self.pool = pool
        self.config = config or RouterConfig()
        # serializes counters/breakers/placement.  No I/O ever runs
        # under it: breaker transitions mutate inside and journal via
        # _emit_breaker after release
        self._lock = threading.RLock()
        self._rr = itertools.count()         # least-loaded tiebreak
        self._deploy = None                  # _DeployTap while a canary
                                             # deployment is live (guarded
                                             # by _lock)
        self._breakers: dict = {}            # rid -> _Breaker
        self._latency: dict = {}             # rid -> LatencySummary
        self._attempt_counts: dict = {}      # rid -> attempts routed
        # tenant -> request/served/failure counts; LRU-capped (the keys
        # are request-supplied tenant names — see _note_tenant)
        self._tenant_counts: OrderedDict = OrderedDict()
        self.counters = {"requests": 0, "served": 0, "attempts": 0,
                         "retries": 0, "hedges": 0, "hedge_wins": 0,
                         "shed": 0, "no_capacity": 0, "failures": 0,
                         "breaker_opens": 0, "readmissions": 0}
        get_journal().event(
            "router_start", replicas=sorted(pool.replicas),
            retries=self.config.retries, hedge_ms=self.config.hedge_ms,
            breaker_k=self.config.breaker_k,
            capacity_floor=self.config.capacity_floor)

    # -- client surface --------------------------------------------------
    def predict(self, x, deadline_ms=None, priority=0, tenant=None):
        """Route one sample; returns the result value.  Raises the same
        structured errors a single Server does, plus the router tiers
        (``ServerOverloaded(tier=...)``, ``DeadlineExceeded(
        stage='router_budget')``).  ``tenant`` targets a fleet tenant:
        placement prefers replicas whose beacon advertises it
        un-quarantined, and the tenant rides the wire frame."""
        return self.call(x, deadline_ms=deadline_ms,
                         priority=priority, tenant=tenant).value

    def call(self, x, deadline_ms=None, priority=0,
             tenant=None) -> RouterResponse:
        cfg = self.config
        if deadline_ms is None:
            deadline_ms = cfg.default_deadline_ms
        deadline_ts = time.monotonic() + deadline_ms / 1000.0
        x = np.asarray(x)
        with self._lock:
            self.counters["requests"] += 1
        self._note_tenant(tenant, "requests")
        with _trace.span("router_request", priority=priority,
                         tenant=tenant):
            return self._call_routed(x, deadline_ms, deadline_ts,
                                     priority, tenant)

    def _call_routed(self, x, deadline_ms, deadline_ts, priority,
                     tenant=None):
        cfg = self.config
        t0 = time.monotonic()
        self._admit(priority)
        delays = backoff_delays(cfg.retries, cfg.retry_base_s,
                                cfg.retry_max_s, cfg.retry_jitter)
        tried: set = set()
        attempts = 0
        hedged_any = False
        last_exc = None
        for attempt in range(cfg.retries + 1):
            remaining = deadline_ts - time.monotonic()
            if remaining <= 0:
                break
            state = self._pick(exclude=tried, tenant=tenant)
            if state is None and tried:
                # every untried replica is unroutable: widen back out
                # rather than fail a retryable request early
                state = self._pick(exclude=set(), tenant=tenant)
            if state is None:
                self._note_tenant(tenant, "failures")
                self._shed("no_capacity", priority, tenant=tenant)
            tried.add(state.id)
            attempts += 1
            try:
                value, meta, hedged = self._attempt(
                    state, x, remaining, attempt, tenant)
            except RequestError as exc:
                last_exc = exc
                hedged_any = hedged_any or getattr(exc, "_hedged", False)
                self._record_failure(getattr(exc, "_replica", state.id),
                                     exc)
                if not getattr(exc, "retryable", False) \
                        or attempt >= cfg.retries:
                    self._note_tenant(tenant, "failures")
                    raise
                with self._lock:
                    self.counters["retries"] += 1
                get_journal().event(
                    "router_retry", replica=state.id, attempt=attempt + 1,
                    error=type(exc).__name__, detail=str(exc)[:200],
                    tenant=tenant)
                pause = min(delays[attempt],
                            max(deadline_ts - time.monotonic(), 0.0))
                if pause > 0:
                    time.sleep(pause)
                continue
            hedged_any = hedged_any or hedged
            latency_ms = (time.monotonic() - t0) * 1000.0
            self._record_success(meta["replica"], latency_ms)
            with self._lock:
                self.counters["served"] += 1
                tap = self._deploy
            role = None
            if tap is not None:
                role = tap.role(meta["replica"])
                (tap.lat_canary if role == "canary"
                 else tap.lat_control).observe(latency_ms)
                with self._lock:
                    tap.served[role] += 1
                if role == "control":
                    # parity sampling: mirror a fraction of control-served
                    # requests onto a canary replica and compare outputs
                    self._maybe_mirror(tap, x, value, deadline_ms, tenant)
            self._note_tenant(tenant, "served")
            return RouterResponse(
                value, meta["replica"], meta.get("params_step"),
                attempts, hedged_any,
                round((time.monotonic() - t0) * 1000.0, 3),
                deploy_role=role)
        # deadline budget exhausted across retries
        late_ms = max(time.monotonic() - deadline_ts, 0.0) * 1000.0
        err = DeadlineExceeded("router_budget", late_ms,
                               tier="retry_budget", tenant=tenant)
        err.__cause__ = last_exc
        self._note_tenant(tenant, "failures")
        get_journal().event("router_budget_exhausted",
                            attempts=attempts, tenant=tenant,
                            last_error=type(last_exc).__name__
                            if last_exc else None)
        raise err

    # -- decode streams (serving/decode.py) ------------------------------
    def decode(self, tokens, max_new_tokens=None, deadline_ms=None,
               priority=0, tenant=None):
        """Route one autoregressive stream to a replica's continuous
        batcher; returns the generated token list."""
        return self.decode_call(tokens, max_new_tokens=max_new_tokens,
                                deadline_ms=deadline_ms, priority=priority,
                                tenant=tenant).value

    def decode_call(self, tokens, max_new_tokens=None, deadline_ms=None,
                    priority=0, tenant=None) -> RouterResponse:
        """Decode through the same placement/retry/breaker machinery as
        :meth:`call`, with one deliberate difference: NO hedging.  A
        decode stream is stateful on its replica (it occupies a KV slot
        and generates token by token), so a hedged twin would double-
        generate and double-occupy slots for the whole stream, not just
        one batch — the tail-latency lever for decode is the slot pool
        and per-step deadline, not a second copy.  ``SlotsExhausted``
        is retryable: a replica with a full slot pool is a placement
        miss, and the retry loop moves the stream to another replica
        (feeding the breaker nothing — busy is not broken)."""
        cfg = self.config
        if deadline_ms is None:
            deadline_ms = cfg.default_deadline_ms
        deadline_ts = time.monotonic() + deadline_ms / 1000.0
        with self._lock:
            self.counters["requests"] += 1
        self._note_tenant(tenant, "requests")
        with _trace.span("router_decode", priority=priority,
                         tenant=tenant):
            return self._decode_routed(tokens, max_new_tokens,
                                       deadline_ts, priority, tenant)

    def _decode_routed(self, tokens, max_new_tokens, deadline_ts, priority,
                       tenant):
        cfg = self.config
        t0 = time.monotonic()
        self._admit(priority)
        delays = backoff_delays(cfg.retries, cfg.retry_base_s,
                                cfg.retry_max_s, cfg.retry_jitter)
        tried: set = set()
        attempts = 0
        last_exc = None
        for attempt in range(cfg.retries + 1):
            remaining = deadline_ts - time.monotonic()
            if remaining <= 0:
                break
            state = self._pick(exclude=tried, tenant=tenant)
            if state is None and tried:
                state = self._pick(exclude=set(), tenant=tenant)
            if state is None:
                self._note_tenant(tenant, "failures")
                self._shed("no_capacity", priority, tenant=tenant)
            tried.add(state.id)
            attempts += 1
            _atomic.trip("router_attempt", state.id)
            with self._lock:
                self.counters["attempts"] += 1
                self._attempt_counts[state.id] = \
                    self._attempt_counts.get(state.id, 0) + 1
            replica = self.pool.replicas[state.id]
            try:
                with _trace.span("router_attempt", replica=state.id,
                                 tenant=tenant, op="decode"):
                    value, meta = replica.decode(
                        tokens, max_new_tokens=max_new_tokens,
                        deadline_ms=remaining * 1000.0, tenant=tenant)
            except RequestError as exc:
                last_exc = exc
                self._record_failure(state.id, exc)
                if not getattr(exc, "retryable", False) \
                        or attempt >= cfg.retries:
                    self._note_tenant(tenant, "failures")
                    raise
                with self._lock:
                    self.counters["retries"] += 1
                get_journal().event(
                    "router_retry", replica=state.id, op="decode",
                    attempt=attempt + 1, error=type(exc).__name__,
                    detail=str(exc)[:200], tenant=tenant)
                pause = min(delays[attempt],
                            max(deadline_ts - time.monotonic(), 0.0))
                if pause > 0:
                    time.sleep(pause)
                continue
            self._record_success(meta["replica"],
                                 (time.monotonic() - t0) * 1000.0)
            with self._lock:
                self.counters["served"] += 1
            self._note_tenant(tenant, "served")
            return RouterResponse(
                value, meta["replica"], meta.get("params_step"),
                attempts, False,
                round((time.monotonic() - t0) * 1000.0, 3))
        late_ms = max(time.monotonic() - deadline_ts, 0.0) * 1000.0
        err = DeadlineExceeded("router_budget", late_ms,
                               tier="retry_budget", tenant=tenant)
        err.__cause__ = last_exc
        self._note_tenant(tenant, "failures")
        get_journal().event("router_budget_exhausted", op="decode",
                            attempts=attempts, tenant=tenant,
                            last_error=type(last_exc).__name__
                            if last_exc else None)
        raise err

    # -- per-tenant bookkeeping ------------------------------------------
    _TENANT_CAP = 256          # LRU bound: tenant names arrive on the
                               # request path, so this registry must not
                               # grow one entry per novel string forever

    def _note_tenant(self, tenant, key):
        if tenant is None:
            return
        with self._lock:
            row = self._tenant_counts.get(tenant)
            if row is None:
                row = self._tenant_counts[tenant] = {
                    "requests": 0, "served": 0, "failures": 0}
                while len(self._tenant_counts) > self._TENANT_CAP:
                    self._tenant_counts.pop(
                        next(iter(self._tenant_counts)))
            else:
                self._tenant_counts.move_to_end(tenant)
            row[key] += 1

    # -- admission tiers -------------------------------------------------
    def _shed(self, tier, priority, usable=0, total=None, tenant=None):
        total = len(self.pool.replicas) if total is None else total
        key = "no_capacity" if tier == "no_capacity" else "shed"
        with self._lock:
            self.counters[key] += 1
        get_journal().event("router_shed", tier=tier, priority=priority,
                            usable=usable, total=total, tenant=tenant)
        raise ServerOverloaded(usable, total, tier=tier, tenant=tenant)

    def _admit(self, priority):
        """Graceful degradation: when live+ready capacity is below the
        floor, shed lowest-priority first (only priority-0 traffic is
        admitted) instead of failing every class uniformly."""
        floor = self.config.capacity_floor
        if floor <= 0 or priority <= 0:
            return
        usable = sum(1 for s in self.pool.view()
                     if s.alive and s.ready
                     and self._breaker(s.id).state != OPEN)
        total = max(len(self.pool.replicas), 1)
        if usable / total < floor:
            self._shed("capacity_floor", priority, usable, total)

    # -- placement -------------------------------------------------------
    def _breaker(self, rid) -> _Breaker:
        br = self._breakers.get(rid)
        if br is None:
            br = self._breakers.setdefault(rid, _Breaker())
        return br

    def _transition(self, rid, br, to, reason):
        """Mutate one breaker (caller holds ``_lock``) and return the
        journal payload.  The journal write is file I/O every router
        thread would serialize behind, so callers emit the payload via
        :meth:`_emit_breaker` AFTER releasing the lock."""
        frm, br.state = br.state, to
        if to == OPEN:
            br.opened_t = time.monotonic()
            br.probing = False
            self.counters["breaker_opens"] += 1
        if to == CLOSED:
            br.failures = 0
            br.probing = False
            if frm == HALF_OPEN:
                self.counters["readmissions"] += 1
        br.reason = reason
        return {"replica": rid, "frm": frm, "to": to, "reason": reason,
                "failures": br.failures}

    @staticmethod
    def _emit_breaker(events) -> None:
        """Journal deferred breaker transitions (outside every lock)."""
        for ev in events:
            get_journal().event("router_breaker", **ev)

    def _allow(self, rid, alive, ready, events) -> bool:
        """Breaker gate for one candidate (caller holds ``_lock``;
        transition payloads append to ``events`` for post-lock
        emission).  Only a heartbeat STALL opens the breaker here — a
        merely not-ready replica (draining, mid-restart) is out of
        rotation without being declared broken.  The half-open probe
        slot is claimed by ``_pick`` for the replica actually SELECTED,
        never during candidate enumeration."""
        br = self._breaker(rid)
        if br.state == CLOSED:
            if not alive:
                events.append(
                    self._transition(rid, br, OPEN, "heartbeat_stall"))
                return False
            return ready
        if not alive or not ready:
            return False
        if br.state == OPEN:
            if br.opened_t is not None and time.monotonic() - br.opened_t \
                    >= self.config.breaker_cooldown_s:
                events.append(self._transition(rid, br, HALF_OPEN,
                                               "cooldown_elapsed"))
            else:
                return False
        # half-open: admissible only while no probe is in flight
        return not br.probing

    @staticmethod
    def _serves_tenant(state, tenant) -> bool:
        """Tenant-aware placement gate: a fleet replica advertises its
        tenants (+ quarantine state) in the beacon; route a tenant
        request only where the tenant is present and un-quarantined.
        Replicas without a tenant table are tenant-agnostic (a
        single-tenant worker behind a fleet-free pool)."""
        if tenant is None or state.tenants is None:
            return True
        row = state.tenants.get(str(tenant))
        if row is None:
            return False
        return (row or {}).get("state") != "quarantined"

    def _pick(self, exclude, tenant=None):
        """Least-loaded among live + ready + breaker-admitted replicas
        that serve the tenant (queue depth from the ledger; ties rotate
        round-robin)."""
        view = self.pool.view()            # ledger file I/O: OUTSIDE the
        candidates = []                    # lock — a slow shared FS must
        events: list = []                  # not stall every router thread
        with self._lock:
            for s in view:
                if s.id in exclude:
                    continue
                if not self._serves_tenant(s, tenant):
                    continue
                if not self._allow(s.id, s.alive, s.ready, events):
                    continue
                candidates.append(s)
        self._emit_breaker(events)         # journal I/O: after release
        if not candidates:
            return None
        depth = min(s.queue_depth for s in candidates)
        tied = sorted((s for s in candidates if s.queue_depth == depth),
                      key=lambda s: s.id)
        pick = tied[next(self._rr) % len(tied)]
        with self._lock:
            br = self._breaker(pick.id)
            if br.state == HALF_OPEN:
                br.probing = True          # this dispatch IS the probe
        return pick

    def _record_failure(self, rid, exc):
        with self._lock:
            self.counters["failures"] += 1
            tap = self._deploy
            if tap is not None:
                tap.failures[tap.role(rid)] += 1
        # busy is not broken, and a non-retryable caller error (shape
        # reject, cancelled hedge) says nothing about replica health;
        # deadline misses DO count — a replica too slow to answer in
        # budget is exactly what the breaker should take out of rotation
        harmless = isinstance(exc, ServerOverloaded) or (
            not getattr(exc, "retryable", True)
            and not isinstance(exc, DeadlineExceeded))
        if harmless:
            self._release_probe(rid)
            return
        br = self._breaker(rid)
        events: list = []
        with self._lock:
            br.failures += 1
            if br.state == HALF_OPEN:
                events.append(
                    self._transition(rid, br, OPEN, "probe_failed"))
            elif br.state == CLOSED \
                    and br.failures >= self.config.breaker_k:
                events.append(self._transition(rid, br, OPEN,
                                               "consecutive_failures"))
        self._emit_breaker(events)

    def _record_success(self, rid, latency_ms):
        br = self._breaker(rid)
        events: list = []
        with self._lock:
            if br.state == HALF_OPEN:
                events.append(
                    self._transition(rid, br, CLOSED, "probe_succeeded"))
            else:
                br.failures = 0
            lat = self._latency.get(rid)
            if lat is None:
                lat = self._latency.setdefault(
                    rid, LatencySummary(f"router_{rid}_ms"))
        self._emit_breaker(events)
        lat.observe(latency_ms)

    def _release_probe(self, rid):
        br = self._breaker(rid)
        with self._lock:
            if br.state == HALF_OPEN:
                br.probing = False

    # -- attempts + hedging ----------------------------------------------
    def _hedge_delay_s(self, rid):
        cfg = self.config
        if cfg.hedge_ms <= 0:
            return None
        delay_ms = cfg.hedge_ms
        lat = self._latency.get(rid)
        if lat is not None and lat.count >= cfg.hedge_min_samples:
            p99 = lat.percentile(99)
            if p99 is not None:
                delay_ms = max(delay_ms, p99 * cfg.hedge_p99_factor)
        return delay_ms / 1000.0

    def _dispatch(self, state, x, budget_s, cancel, tenant=None):
        """One attempt on one replica (runs in the caller thread or a
        hedge thread).  The trip site is the slow-replica chaos seam —
        path carries the replica id so ``faults.slow_call`` can target
        one replica."""
        _atomic.trip("router_attempt", state.id)
        with self._lock:
            self.counters["attempts"] += 1
            self._attempt_counts[state.id] = \
                self._attempt_counts.get(state.id, 0) + 1
            tap = self._deploy
        if tap is not None and state.id in tap.canary:
            # distinct chaos seam from router_attempt: faults.slow_canary
            # targets exactly canary-bound dispatches (live or mirrored)
            _atomic.trip("deploy_canary", state.id)
        replica = self.pool.replicas[state.id]
        with _trace.span("router_attempt", replica=state.id,
                         tenant=tenant):
            return replica.predict(x, budget_s * 1000.0, cancel=cancel,
                                   tenant=tenant)

    def _attempt(self, state, x, budget_s, attempt_no, tenant=None):
        """Primary attempt with optional hedging; returns
        ``(value, meta, hedged)`` or raises the decisive error."""
        hedge_s = self._hedge_delay_s(state.id)
        if hedge_s is None or hedge_s >= budget_s:
            value, meta = self._dispatch(state, x, budget_s, None,
                                         tenant)
            return value, meta, False

        results = _queue.Queue(maxsize=4)    # bounded: <= 2 writers
        cancels = {}
        ctx = _trace.current_context()
        t_start = time.monotonic()

        def run(st):
            # an arm thread re-anchors under the request span explicitly
            # (context variables do not cross threads), as the current
            # span, so its router_attempt and its wire frame join the
            # request's trace
            with _trace.start_span("router_hedge_arm", parent=ctx,
                                   replica=st.id) as arm:
                try:
                    remaining = budget_s - (time.monotonic() - t_start)
                    v, m = self._dispatch(st, x, max(remaining, 0.01),
                                          cancels[st.id], tenant)
                    results.put_nowait((st, None, v, m))
                    arm.set_attrs(status="ok")
                except BaseException as e:
                    results.put_nowait((st, e, None, None))
                    arm.set_attrs(status=type(e).__name__)

        def launch(st):
            cancels[st.id] = threading.Event()
            threading.Thread(target=run, args=(st,), daemon=True,
                             name=f"mxnet-torch-router-attempt-{st.id}"
                             ).start()

        launch(state)
        in_flight = {state.id: state}
        hedged = False
        try:
            first = results.get(timeout=min(hedge_s, budget_s))
        except _queue.Empty:
            first = None
        if first is None:
            hedge_state = self._pick(exclude=set(in_flight),
                                     tenant=tenant)
            if hedge_state is not None:
                hedged = True
                with self._lock:
                    self.counters["hedges"] += 1
                get_journal().event(
                    "router_hedge", primary=state.id,
                    hedge=hedge_state.id,
                    delay_ms=round(hedge_s * 1000.0, 1))
                launch(hedge_state)
                in_flight[hedge_state.id] = hedge_state
        # first response wins; a failed response yields to the survivor
        last_exc = None
        while in_flight:
            if first is None:
                remaining = budget_s - (time.monotonic() - t_start)
                if remaining <= 0:
                    break
                try:
                    first = results.get(timeout=remaining)
                except _queue.Empty:
                    break
            st, exc, value, meta = first
            first = None
            in_flight.pop(st.id, None)
            if exc is None:
                for rid, ev in cancels.items():
                    if rid != st.id:
                        ev.set()           # loser cancelled at dequeue
                for rid in in_flight:
                    # the loser's result is never consumed — if it held
                    # its replica's half-open probe slot, free it or the
                    # replica is silently out of rotation forever
                    self._release_probe(rid)
                if hedged and st.id != state.id:
                    with self._lock:
                        self.counters["hedge_wins"] += 1
                return value, meta, hedged
            last_exc = exc
            last_exc._replica = st.id
            if in_flight and isinstance(exc, RequestError):
                # the loser's failure still feeds its replica's breaker
                # while the survivor keeps running
                self._record_failure(st.id, exc)
        for ev in cancels.values():
            ev.set()                       # nobody won: recall them all
        for rid in in_flight:              # unresolved attempts: free any
            self._release_probe(rid)       # probe slot they were holding
        if last_exc is not None:
            last_exc._hedged = hedged
            raise last_exc
        late_ms = max((time.monotonic() - t_start) - budget_s, 0) * 1000.0
        err = DeadlineExceeded("router_wait", late_ms)
        err._hedged = hedged
        raise err

    # -- canary deployment tap (serving/deploy.py) -----------------------
    def set_deploy(self, canary, mirror_fraction=0.0, rtol=1e-5,
                   atol=1e-6) -> "_DeployTap":
        """Install the canary/control tap for one deployment: responses
        gain ``deploy_role``, canary-bound dispatches trip the
        ``deploy_canary`` chaos site, and (``mirror_fraction`` > 0) a
        deterministic 1-in-N sample of control-served requests is
        mirrored onto a canary replica and compared tolerance-gated.
        One deploy at a time — installing over a live tap is a bug in
        the caller (the pool's deploy ownership already serializes)."""
        tap = _DeployTap(canary, mirror_fraction, rtol, atol)
        with self._lock:
            self._deploy = tap
        return tap

    def clear_deploy(self) -> None:
        with self._lock:
            self._deploy = None

    def deploy_stats(self):
        """One consistent snapshot of the live tap (None outside a
        deploy) — the DeployController's gate-evaluation source."""
        with self._lock:
            tap = self._deploy
            if tap is None:
                return None
            out = {"canary": sorted(tap.canary),
                   "served": dict(tap.served),
                   "failures": dict(tap.failures),
                   "mirrors": tap.mirrors,
                   "mirror_mismatch": tap.mirror_mismatch,
                   "mirror_errors": tap.mirror_errors,
                   "mirror_skipped": tap.mirror_skipped}
        for arm, lat in (("canary", tap.lat_canary),
                         ("control", tap.lat_control)):
            out[f"{arm}_count"] = lat.count
            out[f"{arm}_p99_ms"] = lat.percentile(99) if lat.count else None
        return out

    def _maybe_mirror(self, tap, x, expect, deadline_ms, tenant):
        """Sampling + in-flight-cap gate for one mirror candidate; the
        actual duplicate dispatch runs on a bounded daemon thread so the
        client never pays the second attempt's latency."""
        with self._lock:
            if tap is not self._deploy or tap.mirror_every <= 0:
                return
            tap._n += 1
            if tap._n % tap.mirror_every:
                return
            if tap.mirror_inflight >= tap.max_inflight:
                tap.mirror_skipped += 1    # bounded, never queued: a slow
                return                     # canary must not pile threads
            tap.mirror_inflight += 1
        ctx = _trace.current_context()
        threading.Thread(
            target=self._run_mirror,
            args=(tap, x, expect, deadline_ms, tenant, ctx),
            daemon=True, name="mxnet-torch-router-mirror").start()

    def _run_mirror(self, tap, x, expect, deadline_ms, tenant, ctx):
        """One mirrored parity probe: duplicate the request onto an
        alive+ready canary replica, compare against the control answer
        within (rtol, atol).  A mismatch journals
        ``deploy_mirror_mismatch`` (under the request's trace); a
        transport/predict failure counts as a mirror error — the gate
        reads both."""
        try:
            with _trace.start_span("deploy_mirror", parent=ctx) as sp:
                view = self.pool.view()
                cands = [s for s in view if s.id in tap.canary
                         and s.alive and s.ready]
                if not cands:
                    with self._lock:
                        tap.mirrors += 1
                        tap.mirror_errors += 1
                    sp.set_attrs(status="no_canary")
                    return
                st = cands[next(self._rr) % len(cands)]
                _atomic.trip("deploy_canary", st.id)
                try:
                    got, meta = self.pool.replicas[st.id].predict(
                        x, deadline_ms, cancel=None, tenant=tenant)
                except Exception as e:
                    with self._lock:
                        tap.mirrors += 1
                        tap.mirror_errors += 1
                    sp.set_attrs(status=type(e).__name__)
                    return
                a = np.asarray(got, dtype=np.float64)
                b = np.asarray(expect, dtype=np.float64)
                ok = a.shape == b.shape and bool(
                    np.allclose(a, b, rtol=tap.rtol, atol=tap.atol))
                with self._lock:
                    tap.mirrors += 1
                    if not ok:
                        tap.mirror_mismatch += 1
                sp.set_attrs(status="ok" if ok else "mismatch",
                             replica=st.id)
                if not ok:
                    delta = (float(np.max(np.abs(a - b)))
                             if a.shape == b.shape else None)
                    get_journal().event(
                        "deploy_mirror_mismatch", replica=st.id,
                        step=meta.get("params_step"), max_abs_delta=delta)
        finally:
            with self._lock:
                tap.mirror_inflight -= 1

    # -- reporting -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            attempts = dict(self._attempt_counts)
            tenants = {t: dict(row)
                       for t, row in self._tenant_counts.items()}
        per_replica = {}
        for rid in self.pool.replicas:
            br = self._breakers.get(rid)
            lat = self._latency.get(rid)
            per_replica[rid] = {
                "attempts": attempts.get(rid, 0),
                "breaker": br.state if br else CLOSED,
                "p99_ms": lat.percentile(99) if lat is not None
                and lat.count else None}
        out = {**counters, "replicas": per_replica}
        if tenants:
            out["tenants"] = tenants
        deploy = self.deploy_stats()
        if deploy is not None:
            out["deploy"] = deploy
        return out

    def metrics_text(self) -> str:
        """Prometheus text: the router's counters, breakers and latency
        mirrored into the process default registry at call time (gauge
        mirrors, the same contract as ``Server.metrics_text``)."""
        from ..observability import metrics as _m
        reg = _m.default_registry()
        st = self.stats()
        ev = reg.gauge("mxnet_tpu_router_events",
                       "router counters (cumulative)", ("event",))
        for k, v in st.items():
            if k not in ("replicas", "tenants", "deploy"):
                ev.labels(event=k).set(v)
        dep = st.get("deploy")
        if dep:
            dg = reg.gauge("mxnet_tpu_deploy_arm",
                           "live canary-vs-control stats for the active "
                           "deployment", ("arm", "stat"))
            for arm in ("canary", "control"):
                dg.labels(arm=arm, stat="served").set(dep["served"][arm])
                dg.labels(arm=arm, stat="failures").set(
                    dep["failures"][arm])
                if dep.get(f"{arm}_p99_ms") is not None:
                    dg.labels(arm=arm, stat="p99_ms").set(
                        dep[f"{arm}_p99_ms"])
            mg = reg.gauge("mxnet_tpu_deploy_mirrors",
                           "mirrored parity probes for the active "
                           "deployment", ("outcome",))
            mg.labels(outcome="total").set(dep["mirrors"])
            mg.labels(outcome="mismatch").set(dep["mirror_mismatch"])
            mg.labels(outcome="error").set(dep["mirror_errors"])
        if st.get("tenants"):
            tev = reg.gauge("mxnet_tpu_router_tenant_events",
                            "per-tenant router counters (cumulative)",
                            ("tenant", "event"))
            for t, row in st["tenants"].items():
                for k, v in row.items():
                    tev.labels(tenant=t, event=k).set(v)
        brg = reg.gauge("mxnet_tpu_router_breaker_state",
                        "per-replica breaker (0 closed, 1 half-open, "
                        "2 open)", ("replica",))
        att = reg.gauge("mxnet_tpu_router_attempts_total",
                        "attempts routed per replica", ("replica",))
        p99 = reg.gauge("mxnet_tpu_router_replica_p99_ms",
                        "per-replica end-to-end p99 as seen by the "
                        "router", ("replica",))
        for rid, row in st["replicas"].items():
            brg.labels(replica=rid).set(_BREAKER_CODE[row["breaker"]])
            att.labels(replica=rid).set(row["attempts"])
            if row["p99_ms"] is not None:
                p99.labels(replica=rid).set(row["p99_ms"])
        return reg.prometheus_text()

    def stop(self) -> None:
        get_journal().event("router_stop", **{
            k: v for k, v in self.stats().items() if k != "replicas"})
