"""Request plumbing for the dynamic batcher — stdlib-only.

A copy of ``mxnet_tpu/serving/batcher.py`` (the port imports nothing of
the JAX package).

A :class:`Request` is one sample (no batch axis) plus its admission
timestamp and absolute deadline; completion is a ``threading.Event`` the
submitting thread waits on through :class:`PendingResponse`.  The worker
thread groups admitted requests into micro-batches with
:func:`take_batch`: FIFO within a feature-bucket key, capped at the
largest batch bucket, leaving differently-bucketed requests pending for
the next cycle (so one odd-shaped request never pads — or blocks — a
whole batch of the common shape).

Deadline semantics (docs/serving.md): a deadline is checked twice —
at dequeue (:func:`drop_expired`; a request that already missed must not
waste a batch slot) and again post-batch by the server (a result that
arrives late is an error, not a silently-slow success).  Both misses
surface as :class:`DeadlineExceeded` on the caller's ``result()``.
"""
from __future__ import annotations

import threading
import time

__all__ = ["DeadlineExceeded", "PendingResponse", "Request",
           "RequestCancelled", "RequestError", "ServerOverloaded",
           "ServerStopped", "SlotsExhausted", "drop_expired", "take_batch"]


class RequestError(RuntimeError):
    """Structured per-request failure (bad shape, predictor error).

    ``retryable`` is the replica-pool router's classification hook
    (serving/router.py): True when the same request may succeed on a
    DIFFERENT replica (predictor fault, stopped/overloaded server);
    the shape-reject path overrides it to False on the instance — every
    replica shares the bucket grid, so retrying is wasted budget.
    ``tenant`` names the fleet tenant the failure belongs to (None on a
    single-tenant Server) — the tenant-isolation contract requires every
    structured error to carry its fault domain (docs/serving.md)."""

    retryable = True
    tenant = None


class ServerOverloaded(RequestError):
    """Admission rejected: the bounded queue is full — or, with
    ``tier`` set, a pool-level degradation tier acted (the router's
    capacity-floor shed, the fleet's per-tenant-class depth budget or
    token-bucket rate budget; docs/serving.md).  Raised to the
    *submitter* immediately — the explicit load-shed that keeps queue
    latency bounded instead of letting every client get slower."""

    def __init__(self, depth, limit, tier=None, tenant=None):
        super().__init__(f"serving queue full ({depth}/{limit}); request "
                         "shed — retry with backoff or scale out"
                         + (f" [tier: {tier}]" if tier else "")
                         + (f" [tenant: {tenant}]" if tenant else ""))
        self.depth = depth
        self.limit = limit
        self.tier = tier
        self.tenant = tenant


class ServerStopped(RequestError):
    """Admission is closed: ``stop()`` has begun (or finished) on this
    server.  Raised at ``submit()`` once the server is stopping, and set
    on any straggler found in the queue after the worker exited — a
    stop can never turn a request into a silent result-timeout."""

    def __init__(self, detail="server stopped"):
        super().__init__(f"{detail} — admission closed; submit to "
                         "another replica or restart the server")


class SlotsExhausted(RequestError):
    """Decode-slot admission rejected: every KV-cache slot is occupied
    and the stream asked not to queue (serving/decode.py,
    ``queue_on_busy=False``).  Retryable — unlike a shape reject, a
    DIFFERENT replica may well have a free slot, so the pool router's
    retry loop treats this as a placement miss, not a dead request."""

    def __init__(self, slots, queued=0, tenant=None):
        super().__init__(f"all {slots} decode slots occupied "
                         f"({queued} queued); stream not admitted — "
                         "retry on another replica"
                         + (f" [tenant: {tenant}]" if tenant else ""))
        self.slots = slots
        self.queued = queued
        self.tenant = tenant


class RequestCancelled(RequestError):
    """The request was cancelled before execution (a hedged attempt
    whose twin already answered): dropped at dequeue, never spending a
    batch slot.  Not retryable — the caller already has its result."""

    retryable = False


class DeadlineExceeded(RequestError):
    """The request's deadline passed before (stage='dequeue') or while
    (stage='post_batch') it was served; stage='router_budget' means the
    pool router's retry/hedge budget ran out first (``tier`` names the
    budget that acted).  Never retryable: the time is gone."""

    retryable = False

    def __init__(self, stage, late_ms, tier=None, tenant=None):
        super().__init__(f"deadline exceeded at {stage} "
                         f"({late_ms:.1f} ms late)"
                         + (f" [tier: {tier}]" if tier else "")
                         + (f" [tenant: {tenant}]" if tenant else ""))
        self.stage = stage
        self.late_ms = late_ms
        self.tier = tier
        self.tenant = tenant


class Request:
    """One admitted sample and its completion slot."""

    __slots__ = ("payload", "shape", "key", "enq_t", "deadline_ts",
                 "done", "result", "error", "served_t", "trace",
                 "cancel", "params_step", "tenant")

    def __init__(self, payload, shape, key, deadline_s=None, now=None,
                 cancel=None, tenant=None):
        now = time.monotonic() if now is None else now
        self.payload = payload
        self.shape = tuple(shape)            # original feature shape
        self.key = key                       # bucketed feature shape
        self.enq_t = now
        self.deadline_ts = None if deadline_s is None else now + deadline_s
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.served_t = None
        # the request's root span (observability.trace.start_span —
        # the shared no-op with tracing off), opened at submit and
        # closed by whichever thread resolves the request; None only
        # for Requests constructed outside Server.submit
        self.trace = None
        # cooperative cancellation (hedged attempts): a threading.Event
        # the worker checks at dequeue — set it and the request is
        # dropped with RequestCancelled instead of spending a batch slot
        self.cancel = cancel
        # the checkpoint step whose parameters served this request,
        # stamped by the worker at batch time (the rolling-reload
        # version-stamp contract; None = initializer weights)
        self.params_step = None
        # fleet tenant this request belongs to (None on a single-tenant
        # Server): the worker batches per (tenant, key) and every
        # structured failure carries it (docs/serving.md)
        self.tenant = tenant

    def cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.is_set()

    def late_ms(self, now=None) -> float:
        if self.deadline_ts is None:
            return 0.0
        now = time.monotonic() if now is None else now
        return max(now - self.deadline_ts, 0.0) * 1000.0

    def expired(self, now=None) -> bool:
        return self.deadline_ts is not None and \
            (time.monotonic() if now is None else now) > self.deadline_ts

    def set_result(self, value, now=None):
        self.served_t = time.monotonic() if now is None else now
        self.result = value
        self.done.set()

    def set_error(self, exc, now=None):
        self.served_t = time.monotonic() if now is None else now
        self.error = exc
        self.done.set()


class PendingResponse:
    """Caller-side handle: ``result(timeout_s)`` blocks (bounded) until
    the worker completes the request, then returns the value or raises
    the request's structured error."""

    def __init__(self, request: Request, default_timeout_s: float = 60.0):
        self._request = request
        self._default_timeout_s = default_timeout_s

    def result(self, timeout_s=None):
        timeout_s = self._default_timeout_s if timeout_s is None \
            else timeout_s
        if not self._request.done.wait(timeout=timeout_s):
            raise RequestError(
                f"no response within {timeout_s:g}s (server stopped or "
                "wedged — check the serving journal)")
        if self._request.error is not None:
            raise self._request.error
        return self._request.result

    def done(self) -> bool:
        return self._request.done.is_set()

    @property
    def latency_ms(self):
        if self._request.served_t is None:
            return None
        return (self._request.served_t - self._request.enq_t) * 1000.0

    @property
    def params_step(self):
        """Checkpoint step whose parameters produced this response
        (stamped at batch time; None before completion or when the
        server runs on initializer weights)."""
        return self._request.params_step


def drop_expired(pending, on_expired, now=None):
    """Remove already-expired requests from ``pending`` (in place),
    reporting each through ``on_expired(request)`` — the dequeue-time
    half of the deadline contract."""
    now = time.monotonic() if now is None else now
    keep = []
    for req in pending:
        if req.expired(now):
            on_expired(req)
        else:
            keep.append(req)
    pending[:] = keep
    return pending


def take_batch(pending, grid, group_key=None):
    """Pop the next micro-batch off ``pending`` (in place): the oldest
    request's grouping key selects the batch; same-group requests join
    in FIFO order up to the largest batch bucket.  ``group_key``
    defaults to the feature-bucket key; the tenant fleet groups by
    ``(tenant, key)`` so two tenants' requests never share an
    executable.  Returns ``(batch, batch_bucket, feature_key)`` or
    ``(None, None, None)`` when pending is empty."""
    if not pending:
        return None, None, None
    gk = group_key if group_key is not None else (lambda r: r.key)
    head = gk(pending[0])
    batch, rest = [], []
    for req in pending:
        if gk(req) == head and len(batch) < grid.max_batch:
            batch.append(req)
        else:
            rest.append(req)
    pending[:] = rest
    return batch, grid.batch_bucket(len(batch)), batch[0].key
