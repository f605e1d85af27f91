"""Tenant fleet — N model families on one serving worker, isolated
(counterpart of ``mxnet_tpu/serving/fleet.py``).

A :class:`Fleet` generalizes :class:`~.server.Server` from one predictor
family to a **tenant registry**: each tenant is a model (a Block from
``factory=`` or ``block=``), its own commit root (a
:class:`~.reload.ParamStore` per tenant) and an SLO class, multiplexed
on the same bounded queue, worker thread and predictor cache. Tenants
hot add, remove and reload at runtime; batches group per ``(tenant,
feature_key)``, so two tenants never share a predictor.

The robustness contract is the reference's:

- **SLO-classed admission**: each tenant's class carries a priority, a
  deadline floor and a token-bucket rate budget. A lower-priority class
  loses queue room as depth grows (its share of the bound halves per
  priority tier) while priority-0 tenants keep the full queue; a tenant
  over its rate budget sheds only itself. Every ``ServerOverloaded`` /
  ``DeadlineExceeded`` carries the tenant and the tier.
- **Per-tenant fault domains**: a tenant whose committed checkpoint
  fails CRC, whose shapes reject, or whose predictor throws feeds a
  per-tenant breaker; at the threshold the tenant is **quarantined**
  (:class:`TenantQuarantined` at admission, queued requests resolved at
  dequeue without spending batch slots). After a cooldown the breaker
  goes half-open: one probe request re-admits it or quarantines it
  again. Every transition is journaled (``tenant_quarantine``) under its
  own span.
- **Weight paging**: at most ``max_hot_tenants`` tenants keep their
  parameters and predictors on the device. A cold tenant's parameters
  live in a host snapshot and page in on demand; the LRU evicts the
  stalest hot tenant and drops its predictors from the cache.

On the card a page-out really frees the device: the tenant's CUDA
graphs and their pools are released, its parameters and buffers are
copied into pinned host tensors (a bf16 tenant stays bf16: numpy has no
bfloat16 here) and their device storage is freed in place, so a tenant
registered with ``block=`` (which its factory keeps alive) holds no
device memory while cold. A page-in copies the snapshot back into the
block's tensors, catches up with the newest valid committed step and
captures the graph of the batch that asked for it: ``tenant_page_in``
journals that whole cost (``cost_ms``, with the port's ``capture_s``
and ``bytes``), and the batch's ``exec_ms`` excludes it. Reloads copy
the new step into the live tensors in place, as ``Server`` does, so
the tenant's captured graphs serve it without a capture.

Chaos seam: every tenant predictor call trips the ``serving_tenant``
site with the tenant name as its path, so a fault hook can target one
tenant.

A tenant's factory may return an imported ``gluon.SymbolBlock``
(``SymbolBlock.imports`` of an exported pair), as in the JAX package.

Not ported: the AOT disk store (ROADMAP Queue 1 item 5g), so
``_restore_predictors`` restores nothing, as the reference's does
without one.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch
from torch.nn.parameter import is_lazy

from ..base import MXNetError
from ..diagnostics.journal import get_journal
from ..metric import LatencySummary
from ..observability import instrument as _obs
from ..observability import trace as _trace
from ..resilience import atomic as _atomic
from ..resilience.retry import _env_float, _env_int
from .batcher import RequestError, ServerOverloaded
from .reload import ParamStore
from .server import Server, ServerConfig, _check_device, _end_span

__all__ = ["Fleet", "FleetConfig", "SLOClass", "TenantQuarantined",
           "TenantState", "SLO_CLASSES"]

ADMITTED, QUARANTINED, HALF_OPEN = "admitted", "quarantined", "half_open"


class TenantQuarantined(RequestError):
    """The tenant's per-tenant breaker is open: its checkpoint, shapes,
    or predictor faulted past the threshold and the tenant is out of
    admission until a half-open probe succeeds.  Not retryable — the
    fault is the tenant's own artifact (shared commit root / model),
    so another replica would fail the same way."""

    retryable = False

    def __init__(self, tenant, reason, state=QUARANTINED):
        super().__init__(
            f"tenant {tenant!r} quarantined ({reason}) — its own "
            "checkpoint/shape/predictor faults tripped the per-tenant "
            "breaker; other tenants are unaffected")
        self.tenant = tenant
        self.reason = reason
        self.state = state


@dataclass(frozen=True)
class SLOClass:
    """One admission class: ``priority`` 0 is highest (keeps the full
    queue bound; each tier below halves its share), ``deadline_floor_ms``
    lifts any shorter requested deadline, ``rate_rps``/``burst`` arm a
    per-tenant token bucket (0 = unlimited)."""

    name: str = "standard"
    priority: int = 0
    deadline_floor_ms: float = 0.0
    rate_rps: float = 0.0
    burst: float = 8.0


SLO_CLASSES = {
    "gold": SLOClass("gold", priority=0),
    "silver": SLOClass("silver", priority=1),
    "bronze": SLOClass("bronze", priority=2),
}


@dataclass
class FleetConfig(ServerConfig):
    """Fleet knobs on top of :class:`ServerConfig` (the
    ``MXNET_TPU_TENANT_*`` environment variables set the defaults)."""

    max_hot_tenants: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_TENANT_MAX_HOT", 4))
    tenant_breaker_k: int = field(default_factory=lambda: _env_int(
        "MXNET_TPU_TENANT_BREAKER_K", 3))
    tenant_cooldown_s: float = field(default_factory=lambda: _env_float(
        "MXNET_TPU_TENANT_COOLDOWN_S", 5.0))


class _TokenBucket:
    """Per-tenant rate budget: ``rate_rps`` tokens/s up to ``burst``;
    an admission costs one token.  0 rate = unlimited."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate_rps, burst):
        self.rate = float(rate_rps)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.stamp = time.monotonic()

    def allow(self) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class TenantState:
    """One tenant's fault domain: model handle (the device block while
    hot, a host snapshot of its tensors while cold), ParamStore, SLO
    class, breaker, rate bucket, counters and latency summary."""

    def __init__(self, name, factory, store, slo):
        self.name = name
        self.factory = factory
        self.store = store
        self.slo = slo
        self.block = None              # device-resident only while hot
        self.host_params = None        # structural name -> host tensor
        self.params_step = None
        self.last_reload_check = None
        self.bucket = _TokenBucket(slo.rate_rps, slo.burst)
        self.latency = LatencySummary(f"tenant_{name}_ms")
        # breaker
        self.state = ADMITTED
        self.failures = 0
        self.opened_t = None
        self.probing = False
        self.reason = None
        self.removed = False
        self.reload_forced = False     # reload_tenant() -> worker applies
        self.counters = {"accepted": 0, "served": 0, "shed": 0,
                         "rejected_shape": 0, "quarantine_rejects": 0,
                         "errors": 0, "deadline_miss": 0, "reloads": 0,
                         "page_ins": 0, "page_outs": 0, "quarantines": 0,
                         "readmissions": 0}


def _unique_tensors(block):
    """(structural name, tensor) of every parameter and buffer of
    ``block``, each tensor once (a tied weight under its first name)."""
    seen = set()
    for name, t in block.collect_params().items():
        if id(t) not in seen:
            seen.add(id(t))
            yield name, t


def _snapshot_and_free(block, device):
    """Copy every tensor of ``block`` to the host (pinned on the card)
    and free its device storage in place; returns ({name: host tensor},
    bytes). The block's objects stay; only their storage goes."""
    snap, nbytes = {}, 0
    with torch.no_grad():
        for name, t in _unique_tensors(block):
            if is_lazy(t):
                continue               # nothing materialized to keep
            if device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.detach().clone()
            snap[name] = host
            nbytes += host.numel() * host.element_size()
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        for name, t in _unique_tensors(block):
            if name in snap:
                t.data = torch.empty(0, dtype=t.dtype, device=t.device)
    return snap, nbytes


def _restore(block, snap, device):
    """Copy a host snapshot into ``block``'s tensors on ``device``: in
    place where a tensor is live with the snapshot's shape (a fresh
    factory build), into new storage where a page-out freed it (the same
    block paged in again). Returns the bytes copied."""
    nbytes = 0
    with torch.no_grad():
        for name, t in _unique_tensors(block):
            host = snap.get(name)
            if host is None:
                continue
            if is_lazy(t):
                raise MXNetError(f"tenant block parameter {name} is not "
                                 "materialized; a factory must return an "
                                 "initialized block")
            if tuple(t.shape) == tuple(host.shape) and t.device == device:
                t.copy_(host, non_blocking=True)
            else:
                t.data = host.to(device, non_blocking=True)
            nbytes += host.numel() * host.element_size()
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
    return nbytes


class Fleet(Server):
    """Multi-tenant serving engine: one worker thread, one bounded
    queue, N isolated tenant families.  ``submit(x, tenant=...)`` is
    the whole client-side difference from a single-tenant Server. Runs
    on ``cuda:0`` unless ``ctx`` asks for the CPU; raises without a
    card otherwise."""

    def __init__(self, config=None, ctx=None):
        super().__init__(block=None, config=config or FleetConfig(),
                         ctx=ctx)
        if not isinstance(self.config, FleetConfig):
            # a plain ServerConfig still works: the fleet knobs fall back
            # to their environment or default values
            base, self.config = self.config, FleetConfig()
            for f in base.__dataclass_fields__:
                setattr(self.config, f, getattr(base, f))
        self.tenants: "OrderedDict[str, TenantState]" = OrderedDict()
        self._hot: "OrderedDict[str, bool]" = OrderedDict()  # LRU, newest last
        self._tlock = threading.RLock()
        self._group_key = lambda r: (r.tenant, r.key)

    # -- tenant registry (hot add/remove/reload) -------------------------
    def add_tenant(self, name, factory=None, block=None, ckpt_root=None,
                   slo=None, params_file=None) -> "Fleet":
        """Register (or hot-add, while serving) one tenant.  ``factory``
        builds its initialized block on the fleet's device at page-in; a
        prebuilt ``block`` (already on that device) is wrapped into a
        factory.  ``slo`` is an :class:`SLOClass` or a preset name
        (``gold|silver|bronze``, default gold)."""
        name = str(name)
        if factory is None and block is None:
            raise ValueError(f"tenant {name!r} needs factory= or block=")
        if factory is None:
            _check_device(block, self.device)
            factory = lambda: block                      # noqa: E731
        if isinstance(slo, str):
            slo = SLO_CLASSES[slo]
        slo = slo or SLO_CLASSES["gold"]
        store = ParamStore(ckpt_root, params_file=params_file) \
            if ckpt_root else None
        with self._tlock:
            if name in self.tenants and not self.tenants[name].removed:
                raise ValueError(f"tenant {name!r} already registered")
            self.tenants[name] = TenantState(name, factory, store, slo)
        get_journal().event("tenant_add", tenant=name, slo=slo.name,
                            priority=slo.priority, ckpt_root=ckpt_root,
                            rate_rps=slo.rate_rps)
        return self

    def remove_tenant(self, name) -> None:
        """Hot-remove: admission rejects immediately; queued requests
        are resolved structurally at dequeue; the device block and the
        predictors are dropped."""
        name = str(name)
        with self._tlock:
            ts = self.tenants.pop(name, None)
            if ts is None:
                raise KeyError(f"unknown tenant {name!r}")
            ts.removed = True
            ts.block = None
            ts.host_params = None
            self._hot.pop(name, None)
        dropped = self.cache.drop_where(lambda k: k[0] == name)
        get_journal().event("tenant_remove", tenant=name,
                            predictors_dropped=dropped,
                            **ts.counters)

    def reload_tenant(self, name) -> None:
        """Ask for an immediate hot-reload poll of one tenant.  The
        worker applies it between batches (never the caller's thread,
        which could change parameters under a running predictor); a cold
        tenant picks up the newest valid step at page-in regardless."""
        with self._tlock:
            self.tenants[str(name)].reload_forced = True

    # -- admission (tenant hooks on Server.submit) -----------------------
    def _admit_tenant(self, tenant, payload):
        if tenant is None:
            err = RequestError("fleet requests must name a tenant "
                               "(submit(x, tenant=...))")
            err.retryable = False
            raise err
        events: list = []
        shed = False
        try:
            with self._tlock:
                ts = self.tenants.get(str(tenant))
                if ts is None or ts.removed:
                    err = RequestError(f"unknown tenant {tenant!r} — "
                                       "not in this fleet's registry")
                    err.retryable = True   # another replica may serve it
                    err.tenant = tenant
                    raise err
                self._breaker_gate(ts, events)
                if not ts.bucket.allow():
                    ts.counters["shed"] += 1
                    self._release_probe(ts)
                    shed = True
        finally:
            # the quarantine gate raises through this path: its
            # transitions journal either way, outside _tlock
            self._emit_quarantine(events)
        if shed:
            with self._lock:
                self.counters["shed"] += 1
            get_journal().event("serving_shed", tenant=ts.name,
                                tier="rate_budget",
                                rate_rps=ts.slo.rate_rps)
            raise ServerOverloaded(
                self._queue.qsize(), self.config.max_queue,
                tier="rate_budget", tenant=ts.name)
        return ts

    def _release_probe(self, ts):
        """A half-open probe that never reaches the device (shed,
        cancelled, deadline-missed) frees the probe slot, or the tenant
        would stay half-open for ever."""
        if ts.state == HALF_OPEN:
            ts.probing = False

    def _breaker_gate(self, ts, events):
        """Quarantine gate at admission (caller holds ``_tlock``;
        transitions are appended to ``events`` for emission after the
        lock): a quarantined tenant rejects until the cooldown elapses,
        then goes half-open and admits exactly one probe."""
        if ts.state == ADMITTED:
            return
        if ts.state == QUARANTINED:
            cooldown = self.config.tenant_cooldown_s
            if ts.opened_t is None or \
                    time.monotonic() - ts.opened_t < cooldown:
                ts.counters["quarantine_rejects"] += 1
                raise TenantQuarantined(ts.name, ts.reason or "faulted")
            events.append(
                self._transition(ts, HALF_OPEN, "cooldown_elapsed"))
        # half-open: one probe in flight at a time. A busy probe slot is
        # retryable (this replica's slot, not the tenant's artifact)
        if ts.probing:
            ts.counters["quarantine_rejects"] += 1
            err = TenantQuarantined(ts.name, "probe in flight", HALF_OPEN)
            err.retryable = True
            raise err
        ts.probing = True

    def _transition(self, ts, to, reason):
        """Move one tenant breaker (caller holds ``_tlock``) and return
        the journal payload, emitted by :meth:`_emit_quarantine` after
        the lock is released."""
        frm, ts.state = ts.state, to
        if to == QUARANTINED:
            ts.opened_t = time.monotonic()
            ts.probing = False
            ts.counters["quarantines"] += 1
        if to == ADMITTED:
            ts.failures = 0
            ts.probing = False
            if frm == HALF_OPEN:
                ts.counters["readmissions"] += 1
        ts.reason = reason
        return {"tenant": ts.name, "frm": frm, "to": to,
                "reason": reason, "failures": ts.failures}

    @staticmethod
    def _emit_quarantine(events) -> None:
        """Journal deferred quarantine transitions (outside ``_tlock``),
        each under its own ``tenant_quarantine`` span (a child of the
        active request or batch span, else a fresh root), so the trail
        is trace-correlated whichever thread trips it."""
        for ev in events:
            attrs = {k: v for k, v in ev.items() if k != "failures"}
            with _trace.span("tenant_quarantine", **attrs):
                get_journal().event("tenant_quarantine", **ev)

    def _tenant_failure(self, ts, reason):
        """One breaker feed: shape reject, corrupt committed checkpoint,
        or predictor error.  K consecutive failures, or any failure
        while half-open, quarantine the tenant (only)."""
        events: list = []
        with self._tlock:
            ts.failures += 1
            if ts.state == HALF_OPEN:
                events.append(self._transition(
                    ts, QUARANTINED, f"probe_failed:{reason}"))
            elif ts.state == ADMITTED and \
                    ts.failures >= self.config.tenant_breaker_k:
                events.append(self._transition(ts, QUARANTINED, reason))
        self._emit_quarantine(events)

    def _state_of(self, tenant):
        return self.tenants.get(str(tenant)) if tenant is not None \
            else None

    def _note_reject(self, tenant):
        with self._tlock:
            ts = self._state_of(tenant)
            if ts is None:
                return
            ts.counters["rejected_shape"] += 1
        self._tenant_failure(ts, "shape_reject")

    def _note_shed(self, tenant):
        with self._tlock:
            ts = self._state_of(tenant)
            if ts is not None:
                ts.counters["shed"] += 1
                self._release_probe(ts)

    def _note_accept(self, tenant):
        with self._tlock:
            ts = self._state_of(tenant)
            if ts is not None:
                ts.counters["accepted"] += 1

    def _note_cancelled(self, tenant):
        with self._tlock:
            ts = self._state_of(tenant)
            if ts is not None:
                self._release_probe(ts)

    def _note_deadline_miss(self, tenant):
        with self._tlock:
            ts = self._state_of(tenant)
            if ts is not None:
                ts.counters["deadline_miss"] += 1
                self._release_probe(ts)

    def _effective_deadline(self, deadline_ms, ts):
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        floor = ts.slo.deadline_floor_ms if ts is not None else 0.0
        if floor and deadline_ms is not None and 0 < deadline_ms < floor:
            return floor
        return deadline_ms

    def _class_gate(self, ts, tenant):
        """Shed per tenant class first, never globally: priority p keeps
        ``max_queue / 2**p`` of the shared bound, so as depth grows the
        lowest classes shed while priority-0 traffic still lands."""
        if ts is None or ts.slo.priority <= 0:
            return
        share = int(self.config.max_queue / (2 ** ts.slo.priority))
        depth = self._queue.qsize()
        if depth >= max(share, 1):
            with self._tlock:
                ts.counters["shed"] += 1
                self._release_probe(ts)
            with self._lock:
                self.counters["shed"] += 1
            get_journal().event("serving_shed", tenant=ts.name,
                                tier="class_budget", depth=depth,
                                share=share, priority=ts.slo.priority)
            raise ServerOverloaded(depth, share, tier="class_budget",
                                   tenant=ts.name)

    # -- worker-side sweeps ----------------------------------------------
    def _sweep_unroutable(self, pending):
        """Resolve queued requests of quarantined or removed tenants at
        dequeue: a poisoned flood must not keep spending batch slots
        (the half-open probe is the one exception)."""
        keep = []
        for req in pending:
            with self._tlock:
                ts = self.tenants.get(req.tenant)
                drop = None
                if ts is None or ts.removed:
                    drop = RequestError(
                        f"tenant {req.tenant!r} removed while queued")
                    drop.tenant = req.tenant
                elif ts.state == QUARANTINED:
                    ts.counters["quarantine_rejects"] += 1
                    drop = TenantQuarantined(ts.name,
                                             ts.reason or "faulted")
            if drop is None:
                keep.append(req)
            else:
                _end_span(req, "quarantined")
                req.set_error(drop)
        pending[:] = keep

    # -- predictor acquisition + weight paging ---------------------------
    def _acquire_predictor(self, batch, bucket, key):
        tenant = batch[0].tenant
        with self._tlock:
            ts = self.tenants.get(tenant)
            if ts is None or ts.removed:
                raise RequestError(f"tenant {tenant!r} removed")
        block = self._page_in(ts, (bucket, key))
        return ((tenant, bucket, key, self._dtype.str),
                lambda: self._build_predictor(block, bucket, key))

    def _page_in(self, ts, shape=None):
        """Device residency for one tenant (worker thread only): a hot
        tenant just refreshes its LRU position; a cold one builds its
        block, copies its host snapshot back, may page out the stalest
        hot tenant, catches up with the newest valid committed step and,
        for the batch ``shape`` (bucket, key) that asked, captures its
        predictor. The work runs outside ``_tlock``, so admission on
        other tenants never waits for it; its cost is journaled
        (``tenant_page_in``) and kept out of the batch's ``exec_ms``."""
        with self._tlock:
            if ts.block is not None:
                self._hot[ts.name] = True
                self._hot.move_to_end(ts.name)
                return ts.block
            host = ts.host_params
        t0 = time.perf_counter()
        block = ts.factory()
        nbytes = _restore(block, host, self.device) if host else 0
        _check_device(block, self.device)
        doomed = []
        with self._tlock:
            if ts.removed:
                # remove_tenant raced the build: do not bring the tenant
                # back into the hot set
                raise RequestError(f"tenant {ts.name!r} removed")
            ts.host_params = None
            ts.block = block
            ts.counters["page_ins"] += 1
            self._hot[ts.name] = True
            self._hot.move_to_end(ts.name)
            while len(self._hot) > max(self.config.max_hot_tenants, 1):
                cold_name, _ = self._hot.popitem(last=False)
                cold = self.tenants.get(cold_name)
                if cold is not None:
                    doomed.append(cold)
            hot_now = list(self._hot)
        for cold in doomed:            # outside the lock, as above
            self._page_out(cold)
        self._reload_tenant(ts, force=True)    # newest valid step now
        capture_s = None
        if shape is not None:
            bucket, key = shape
            with _obs.compile_span("serving_predictor", bucket=bucket,
                                   key=list(key), dtype=self._dtype.str,
                                   tenant=ts.name):
                pred, _ = self.cache.get(
                    (ts.name, bucket, key, self._dtype.str),
                    lambda: self._build_predictor(block, bucket, key))
            capture_s = round(pred.capture_s, 6)
        cost_ms = round((time.perf_counter() - t0) * 1000.0, 2)
        restored, restore_ms = self._restore_predictors(ts, block)
        get_journal().event(
            "tenant_page_in", tenant=ts.name, cost_ms=cost_ms,
            predictors_restored=restored, restore_ms=restore_ms,
            evicted=[c.name for c in doomed], hot=hot_now,
            bytes=nbytes, capture_s=capture_s)
        return block

    def _restore_predictors(self, ts, block):
        """The reference reloads a paged-in tenant's executables from its
        AOT disk store here (the shapes it served while hot). The port
        has no store (a CUDA graph cannot be serialized; ROADMAP Queue 1
        item 5g), so, as the reference without one, it restores nothing
        and keeps no list of shapes."""
        return 0, 0.0

    def _page_out(self, ts):
        """Release the tenant's predictors, snapshot its tensors to the
        host and free their device storage (worker thread only; works on
        a local block handle, so a racing ``remove_tenant`` cannot trip
        it). On the card the record carries the bytes the allocator got
        back and what stays allocated."""
        block = ts.block
        if block is None:
            return
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated(self.device) if cuda else None
        dropped = self.cache.drop_where(lambda k: k[0] == ts.name)
        snap, nbytes = _snapshot_and_free(block, self.device)
        with self._tlock:
            if not ts.removed:
                ts.host_params = snap
            ts.block = None
            ts.counters["page_outs"] += 1
        after = torch.cuda.memory_allocated(self.device) if cuda else None
        get_journal().event(
            "tenant_page_out", tenant=ts.name, n_params=len(snap),
            predictors_dropped=dropped, bytes=nbytes,
            ms=round((time.perf_counter() - t0) * 1000.0, 2),
            freed_bytes=None if not cuda else before - after,
            allocated=after)

    # -- execution hooks --------------------------------------------------
    def _trip_sites(self, batch):
        _atomic.trip("serving_predict", self._metrics_id)
        # the per-tenant chaos seam: its path is the tenant's name
        _atomic.trip("serving_tenant", batch[0].tenant)

    def _note_predict_error(self, batch, exc):
        ts = self.tenants.get(batch[0].tenant)
        if ts is None:
            return
        ts.counters["errors"] += len(batch)
        self._tenant_failure(ts, f"predictor_error:{type(exc).__name__}")

    def _batch_step(self, batch):
        ts = self.tenants.get(batch[0].tenant)
        return None if ts is None else ts.params_step

    def _batch_fields(self, batch):
        ts = self.tenants.get(batch[0].tenant)
        # the record's p50/p95/p99 are fleet-wide; this tenant's own p99
        # beside them keeps another tenant's tail out of its report
        p99 = None if ts is None or not ts.latency.count \
            else ts.latency.percentile(99)
        return {"tenant": batch[0].tenant, "tenant_p99_ms": p99}

    def _observe_latency(self, req, ms):
        self.latency.observe(ms)
        ts = self.tenants.get(req.tenant)
        if ts is not None:
            ts.latency.observe(ms)

    def _batch_succeeded(self, batch):
        ts = self.tenants.get(batch[0].tenant)
        if ts is None:
            return
        ts.counters["served"] += sum(1 for r in batch
                                     if r.error is None)
        events: list = []
        with self._tlock:
            if ts.state == HALF_OPEN:
                events.append(
                    self._transition(ts, ADMITTED, "probe_succeeded"))
            else:
                ts.failures = 0        # consecutive-failure semantics
                ts.probing = False
        self._emit_quarantine(events)

    # -- hot reload (per tenant) -------------------------------------------
    def _maybe_reload(self, force=False):
        poll_s = self.config.reload_poll_s
        if poll_s < 0 and not force:
            return False
        now = time.monotonic()
        any_reloaded = False
        with self._tlock:
            states = [ts for ts in self.tenants.values()
                      if ts.store is not None and ts.block is not None]
        for ts in states:
            forced = ts.reload_forced
            if not force and not forced and \
                    ts.last_reload_check is not None and \
                    now - ts.last_reload_check < poll_s:
                continue
            ts.reload_forced = False
            any_reloaded |= self._reload_tenant(ts, force=force or forced)
        return any_reloaded

    def _reload_tenant(self, ts, force=False):
        """One tenant's poll, check and apply, on the worker thread. The
        step is copied into the live tensors in place (``load_dict``), so
        the tenant's captured graphs serve it without a capture. A
        corrupt committed candidate (CRC; ``ckpt_fallback`` journaled by
        the store) or an inapplicable dict (architecture drift) feeds
        this tenant's breaker and nobody else's."""
        store = ts.store
        if store is None or ts.block is None:
            return False
        ts.last_reload_check = time.monotonic()
        corrupt_before = store.corrupt_seen
        got = store.poll()
        for _ in range(store.corrupt_seen - corrupt_before):
            self._tenant_failure(ts, "ckpt_corrupt")
        if got is None:
            return False
        step, loaded = got
        prev = ts.params_step
        loaded = {k: v for k, v in loaded.items()
                  if not k.startswith("__")}
        try:
            self._check_reloadable(loaded, ts.block)
            ts.block.load_dict(loaded, ctx=self._ctx, ignore_extra=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        except Exception as e:
            store.mark_bad(step, revert_to=prev)
            get_journal().event("serving_reload_failed", tenant=ts.name,
                                step=step, error=type(e).__name__,
                                detail=str(e)[:300])
            self._tenant_failure(ts, "ckpt_inapplicable")
            return False
        ts.params_step = step
        ts.counters["reloads"] += 1
        with self._lock:
            self.counters["reloads"] += 1
        get_journal().event("serving_reload", tenant=ts.name, step=step,
                            n_params=len(loaded), prev_step=prev)
        return True

    # -- bucket-lattice prewarm (per tenant) -------------------------------
    def prewarm(self, shapes=None, tenants=None) -> dict:
        """Page in up to ``max_hot_tenants`` tenants (``tenants`` names
        them; default registration order) and build each one's batch
        bucket x feature shape lattice (captures on the card). Runs on
        the caller's thread before the worker starts (``start()``) or
        between batches."""
        shapes = shapes if shapes is not None else self.config.aot_prewarm
        t0 = time.perf_counter()
        with self._tlock:
            names = [str(n) for n in tenants] if tenants is not None \
                else list(self.tenants)
            names = names[:max(self.config.max_hot_tenants, 1)]
        warmed = 0
        skipped = []
        for name in names:
            with self._tlock:
                ts = self.tenants.get(name)
                if ts is None or ts.removed:
                    continue
            block = self._page_in(ts)
            for shape in shapes or ():
                key = self.grid.feature_key(tuple(shape))
                if key is None:
                    skipped.append(list(shape))
                    continue
                for bucket in self.grid.batch_buckets:
                    _, hit = self.cache.get(
                        (name, bucket, key, self._dtype.str),
                        lambda b=bucket, k=key:
                            self._build_ready_predictor(block, b, k))
                    warmed += not hit
        compiled = warmed if self.device.type == "cuda" else 0
        out = {"warmed": warmed, "loaded": 0, "compiled": compiled,
               "skipped": skipped, "tenants": names,
               "ms": round((time.perf_counter() - t0) * 1000.0, 2)}
        self.last_prewarm = out
        return out

    # -- reporting ---------------------------------------------------------
    def tenant_stats(self) -> dict:
        out = {}
        with self._tlock:
            states = list(self.tenants.values())
        for ts in states:
            out[ts.name] = {
                "state": ts.state, "reason": ts.reason,
                "slo": ts.slo.name, "priority": ts.slo.priority,
                "hot": ts.block is not None,
                "params_step": ts.params_step,
                "latency_ms": ts.latency.summary(),
                **ts.counters}
        return out

    def stats(self) -> dict:
        st = super().stats()
        st["tenants"] = self.tenant_stats()
        return st

    def beacon(self) -> dict:
        """Readiness beacon plus the served tenants and their breaker
        states: the pool's heartbeat ledger carries them, so a
        tenant-aware router places around a quarantined tenant."""
        doc = super().beacon()
        with self._tlock:
            doc["tenants"] = {ts.name: {"state": ts.state,
                                        "step": ts.params_step}
                              for ts in self.tenants.values()}
        return doc

    def metrics_text(self) -> str:
        """Server families plus the tenant-labelled families:
        ``mxnet_tpu_serving_tenant_events{tenant,event}``,
        ``..._tenant_state`` (0 admitted / 1 half-open / 2 quarantined),
        and ``..._tenant_latency_ms{tenant,quantile}``."""
        from ..observability import metrics as _m
        super().metrics_text()         # mirrors the fleet-wide families
        reg = _m.default_registry()
        code = {ADMITTED: 0, HALF_OPEN: 1, QUARANTINED: 2}
        ev = reg.gauge("mxnet_tpu_serving_tenant_events",
                       "per-tenant serving counters (cumulative)",
                       ("tenant", "event"))
        stg = reg.gauge("mxnet_tpu_serving_tenant_state",
                        "tenant breaker (0 admitted, 1 half-open, "
                        "2 quarantined)", ("tenant",))
        lq = reg.gauge("mxnet_tpu_serving_tenant_latency_ms",
                       "per-tenant end-to-end latency percentiles",
                       ("tenant", "quantile"))
        counter_keys = ("accepted", "served", "shed", "rejected_shape",
                        "quarantine_rejects", "errors", "deadline_miss",
                        "reloads", "page_ins", "page_outs",
                        "quarantines", "readmissions")
        for name, row in self.tenant_stats().items():
            stg.labels(tenant=name).set(code.get(row["state"], 0))
            for k in counter_keys:
                ev.labels(tenant=name, event=k).set(row[k])
            lat = row["latency_ms"]
            if lat["count"]:
                for q in ("p50", "p95", "p99"):
                    lq.labels(tenant=name, quantile=q).set(lat[q])
        return reg.prometheus_text()
