"""Metrics registry — counters, gauges and histogram summaries with
labeled families and a process-wide default registry (counterpart of
``mxnet_tpu/observability/metrics.py``).

The histogram backend is :class:`LatencySummary` (``metric.py``
re-exports it, and the server's request latency is one): a bounded
reservoir keeps p50/p95/p99 over an unbounded stream in fixed memory,
with exact count/mean/min/max. Counters and gauges are plain locked
floats, host arithmetic only, never a device read.

Exposition: :meth:`MetricsRegistry.prometheus_text` renders the
Prometheus text format; :meth:`MetricsRegistry.snapshot` is a JSON-able
dict. Pure Python: the same classes, seeds and output as the JAX
package's, so two runs over the same observations print the same
summaries.
"""
from __future__ import annotations

import math
import random as _random
import re
import threading

from ..base import MXNetError

__all__ = ["Counter", "Gauge", "LatencySummary", "MetricsRegistry",
           "Summary", "default_registry", "prometheus_text",
           "reset_metrics", "snapshot"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _err(msg):
    return MXNetError(msg)


class LatencySummary:
    """Streaming latency summary over a bounded reservoir.

    One helper for every site that needs count/mean/p50/p95/p99 over an
    unbounded stream of observations in bounded memory: the server's
    request latency, the metrics registry's :class:`Summary` children.
    Vitter's algorithm R keeps a uniform sample of the whole stream in
    ``reservoir_size`` slots, so a long soak neither grows memory nor
    forgets its early tail; count/mean/min/max are exact.

    Thread-safe (one lock per observe/snapshot): load-generator clients
    observe from many threads.  Percentiles use the nearest-rank method
    over the sorted reservoir.  The sampling RNG is seeded
    deterministically per instance so tests see reproducible summaries;
    pass ``rng=random.Random()`` for independent streams.
    """

    def __init__(self, name="latency_ms", reservoir_size=2048, rng=None):
        if reservoir_size < 1:
            raise _err("LatencySummary needs reservoir_size >= 1")
        self.name = str(name)
        self._cap = int(reservoir_size)
        self._rng = rng if rng is not None else _random.Random(0xC0FFEE)
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._buf = []
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def observe(self, value):
        """Record one observation (any real number, e.g. latency in ms)."""
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._buf) < self._cap:
                self._buf.append(v)
            else:
                # algorithm R: keep each of the n seen so far with p=cap/n
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._buf[j] = v

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, p):
        """Nearest-rank percentile over the reservoir; None when empty."""
        with self._lock:
            buf = sorted(self._buf)
        if not buf:
            return None
        rank = max(int(math.ceil((float(p) / 100.0) * len(buf))) - 1, 0)
        return buf[min(rank, len(buf) - 1)]

    def summary(self):
        """One dict: count/mean/min/max + p50/p95/p99 (values rounded to
        3 decimals; all None when nothing was observed)."""
        with self._lock:
            buf = sorted(self._buf)
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        if not count:
            return {"count": 0, "mean": None, "sum": 0.0, "min": None,
                    "max": None, "p50": None, "p95": None, "p99": None}

        def rank(p):
            r = max(int(math.ceil((p / 100.0) * len(buf))) - 1, 0)
            return round(buf[min(r, len(buf) - 1)], 3)

        return {"count": count, "mean": round(total / count, 3),
                "sum": round(total, 3),
                "min": round(lo, 3), "max": round(hi, 3),
                "p50": rank(50), "p95": rank(95), "p99": rank(99)}

    def get(self):
        """EvalMetric-flavored accessor: (name, mean)."""
        return self.name, (self._sum / self._count if self._count else None)


# -- family children ---------------------------------------------------------

class Counter:
    """Monotonic count.  ``set(v)`` exists for mirroring an externally-
    tracked monotonic total (the serving server's counters dict) into
    the exposition — it refuses to go backwards."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        if amount < 0:
            raise _err("Counter.inc() amount must be >= 0")
        with self._lock:
            self._value += amount

    def set(self, value):
        value = float(value)
        with self._lock:
            if value < self._value:
                raise _err(f"Counter.set({value}) would move a monotonic "
                           f"counter backwards (at {self._value})")
            self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Summary:
    """Histogram summary child — a thin veneer over LatencySummary."""

    __slots__ = ("_ls",)

    def __init__(self, reservoir_size=2048):
        self._ls = LatencySummary(reservoir_size=reservoir_size)

    def observe(self, value):
        self._ls.observe(value)

    @property
    def count(self):
        return self._ls.count

    @property
    def sum(self):
        return self._ls.sum

    def percentile(self, p):
        return self._ls.percentile(p)

    def summary(self):
        return self._ls.summary()


_KINDS = {"counter": Counter, "gauge": Gauge, "summary": Summary}


class _Family:
    """One named metric family: fixed label names, children per label
    values.  ``family.labels(phase="data_wait").observe(...)``; a
    label-less family proxies child methods directly."""

    def __init__(self, name, kind, help="", labelnames=()):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise _err(f"invalid label name {ln!r} for metric {name!r}")
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise _err(f"metric {self.name!r} takes labels "
                       f"{self.labelnames}, got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind]()
                self._children[key] = child
            return child

    def _default_child(self):
        if self.labelnames:
            raise _err(f"metric {self.name!r} is labeled "
                       f"{self.labelnames}: call .labels(...) first")
        return self.labels()

    # label-less convenience: family.inc() / .set() / .observe()
    def inc(self, amount=1.0):
        self._default_child().inc(amount)

    def set(self, value):
        self._default_child().set(value)

    def dec(self, amount=1.0):
        self._default_child().dec(amount)

    def observe(self, value):
        self._default_child().observe(value)

    def children(self) -> dict:
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Named families, one per metric; getters are idempotent (the same
    (name, kind) returns the existing family; a kind or label mismatch
    is a structural error, not a silent second family)."""

    def __init__(self):
        self._families: dict = {}
        self._lock = threading.Lock()

    def _family(self, name, kind, help, labelnames):
        if not _NAME_RE.match(name):
            raise _err(f"invalid metric name {name!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise _err(f"metric {name!r} already registered as "
                               f"{fam.kind}, not {kind}")
                if labelnames and tuple(labelnames) != fam.labelnames:
                    raise _err(f"metric {name!r} already registered with "
                               f"labels {fam.labelnames}, not "
                               f"{tuple(labelnames)}")
                return fam
            fam = _Family(name, kind, help, labelnames)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()):
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._family(name, "gauge", help, labelnames)

    def summary(self, name, help="", labelnames=()):
        return self._family(name, "summary", help, labelnames)

    def families(self) -> dict:
        with self._lock:
            return dict(sorted(self._families.items()))

    # -- read-out -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able state of every family: scalar values for counters/
        gauges, the LatencySummary dict for summaries.  Label values key
        a nested dict as ``"k=v,k2=v2"`` (or ``""`` for label-less)."""
        out = {}
        for name, fam in self.families().items():
            values = {}
            for key, child in sorted(fam.children().items()):
                label_key = ",".join(f"{ln}={lv}" for ln, lv
                                     in zip(fam.labelnames, key))
                if fam.kind == "summary":
                    values[label_key] = child.summary()
                else:
                    values[label_key] = child.value
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": values}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines = []
        for name, fam in self.families().items():
            if fam.help:
                lines.append(f"# HELP {name} {_esc_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                pairs = list(zip(fam.labelnames, key))
                if fam.kind == "summary":
                    for q, p in (("0.5", 50), ("0.95", 95), ("0.99", 99)):
                        v = child.percentile(p)
                        if v is None:
                            v = float("nan")
                        lines.append(f"{name}"
                                     f"{_labels(pairs + [('quantile', q)])}"
                                     f" {_num(v)}")
                    lines.append(f"{name}_sum{_labels(pairs)} "
                                 f"{_num(child.sum)}")
                    lines.append(f"{name}_count{_labels(pairs)} "
                                 f"{_num(child.count)}")
                else:
                    lines.append(f"{name}{_labels(pairs)} "
                                 f"{_num(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(pairs) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


def _num(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


_default_lock = threading.Lock()
_default: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    global _default
    # lock-free fast path
    reg = _default
    if reg is not None:
        return reg
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def reset_metrics() -> MetricsRegistry:
    """Fresh default registry (tests)."""
    global _default
    with _default_lock:
        _default = MetricsRegistry()
        return _default


def prometheus_text() -> str:
    return default_registry().prometheus_text()


def snapshot() -> dict:
    return default_registry().snapshot()
