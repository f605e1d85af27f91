"""Shared instrumentation helpers for the hot paths (counterpart of
``mxnet_tpu/observability/instrument.py``, with its metric families).

Both trainers, the serving predictor cache, the decode engine and the
checkpoint commit protocol record the same two shapes of signal:

- **step phases** (data wait / compiled step / guard fetch): a
  monotonic-timed scope observed into the always-on
  ``mxnet_tpu_step_phase_ms{trainer,phase}`` summary (host arithmetic
  only: two ``perf_counter`` reads and one lock per phase), plus a
  nested trace span when ``MXNET_TPU_TRACE`` is on;
- **program builds**: every cache-miss site wraps its build in
  :func:`compile_span`, so the build time lands in
  ``mxnet_tpu_xla_compiles_total{site}`` /
  ``mxnet_tpu_xla_compile_ms{site}`` and, when tracing, in an
  ``xla_compile`` span. The names are the reference's; what they count
  in the port is a program build at the reference's cache-miss sites:
  a CUDA-graph capture on the card, the first eager build on the CPU.
  The families keep the reference's help text too, so a scrape of
  either package reads the same.

No helper here touches a tensor or synchronizes the device. On the card
a phase wraps the host call that launches or replays a graph, so
``compiled_step`` measures the host's enqueue and replay time unless the
site itself waits for the device.
"""
from __future__ import annotations

import contextlib
import time

from . import trace
from .metrics import default_registry

__all__ = ["aot_load_span", "compile_span", "maybe_compile_span",
           "step_phase", "PHASE_METRIC", "COMPILE_COUNT_METRIC",
           "COMPILE_MS_METRIC", "AOT_LOAD_COUNT_METRIC",
           "AOT_LOAD_MS_METRIC"]

PHASE_METRIC = "mxnet_tpu_step_phase_ms"
COMPILE_COUNT_METRIC = "mxnet_tpu_xla_compiles_total"
COMPILE_MS_METRIC = "mxnet_tpu_xla_compile_ms"
AOT_LOAD_COUNT_METRIC = "mxnet_tpu_aot_loads_total"
AOT_LOAD_MS_METRIC = "mxnet_tpu_aot_load_ms"


_phase_cache = None


def _phase_summary():
    # per-registry memo: the family lookup (name validation + registry
    # lock) would otherwise run four times per training step; the cache
    # keys on registry identity so reset_metrics() (tests) invalidates
    global _phase_cache
    reg = default_registry()
    cached = _phase_cache
    if cached is not None and cached[0] is reg:
        return cached[1]
    fam = reg.summary(
        PHASE_METRIC, "per-phase training-step wall time (monotonic), ms",
        ("trainer", "phase"))
    _phase_cache = (reg, fam)
    return fam


@contextlib.contextmanager
def step_phase(trainer, phase, **attrs):
    """One training-step phase: always observed into the phase summary,
    traced as ``<trainer>.<phase>`` when tracing is on."""
    t0 = time.perf_counter()
    with trace.span(f"{trainer}.{phase}", **attrs):
        try:
            yield
        finally:
            _phase_summary().labels(trainer=trainer, phase=phase).observe(
                (time.perf_counter() - t0) * 1000.0)


@contextlib.contextmanager
def compile_span(site, **attrs):
    """One program build at ``site`` (a CUDA-graph capture on the card,
    the first eager build on the CPU): counted, timed, and traced as
    ``xla_compile``."""
    reg = default_registry()
    t0 = time.perf_counter()
    with trace.span("xla_compile", site=site, **attrs):
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            reg.counter(COMPILE_COUNT_METRIC,
                        "XLA trace/lower/compile events",
                        ("site",)).labels(site=site).inc()
            reg.summary(COMPILE_MS_METRIC, "XLA compile wall time, ms",
                        ("site",)).labels(site=site).observe(ms)


@contextlib.contextmanager
def aot_load_span(site, **attrs):
    """One load of a stored program at ``site``: counted, timed, and
    traced as ``aot_load``, a family apart from ``xla_compile`` so a
    warm start's ``compile_stats()`` reads zero builds. No site calls it
    yet: the port's program store is ROADMAP Queue 1 item 5g."""
    reg = default_registry()
    t0 = time.perf_counter()
    with trace.span("aot_load", site=site, **attrs):
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            reg.counter(AOT_LOAD_COUNT_METRIC,
                        "deserialized AOT executable loads",
                        ("site",)).labels(site=site).inc()
            reg.summary(AOT_LOAD_MS_METRIC,
                        "AOT executable load wall time, ms",
                        ("site",)).labels(site=site).observe(ms)


def maybe_compile_span(pending, site, **attrs):
    """``compile_span`` when ``pending`` (this call includes the build:
    a graph-cache miss), else a null context."""
    if pending:
        return compile_span(site, **attrs)
    return contextlib.nullcontext()
