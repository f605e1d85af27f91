"""mxnet_tpu_torch.observability — telemetry (counterpart of
``mxnet_tpu/observability``, with its span names, metric families,
knobs and record schemas):

- :mod:`.trace` — ``span(name, **attrs)`` with process-unique trace and
  span ids, cross-thread parents and rank/replica tags; a bounded ring
  and optional JSONL journal streaming
  (``MXNET_TPU_TRACE=off|ring|journal``). Off is one shared no-op, and
  no mode adds a device synchronization;
- :mod:`.metrics` — counters, gauges and histogram summaries with
  labeled families and a process-wide default registry;
- :mod:`.instrument` — the step-phase and program-build helpers the
  trainers, serving and checkpointing use;
- :mod:`.export` — Chrome trace-event JSON from the ring or a journal
  file, and a stdlib ``/metrics`` HTTP endpoint;
- :mod:`.flight` — the crash flight recorder (``MXNET_TPU_TRACE_DIR``);
- :mod:`.aggregate` — a run directory of per-process journals and
  flight dumps merged into one trace, and one request's critical path.

Every journal record written inside a span carries ``trace_id``/
``span_id``. The ``doctor`` reports (``report.py``) and the
``__main__`` command are ROADMAP Queue 1 item 13.

Stdlib only.
"""
from __future__ import annotations

from . import aggregate, export, flight, instrument, metrics, trace
from .aggregate import (aggregate_chrome, critical_path, scan_run_dir,
                        timeline_report)
from .export import (chrome_trace_from_journal, export_chrome,
                     serve_metrics, to_chrome_trace)
from .flight import FlightRecorder, install_from_env
from .metrics import (Counter, Gauge, LatencySummary, MetricsRegistry,
                      Summary, default_registry, prometheus_text,
                      reset_metrics)
from .trace import (SpanContext, Tracer, adopt_trace, annotate, configure,
                    current_context, current_ids, current_span, enabled,
                    event, get_tracer, identity, reset_tracer, span,
                    start_span)

__all__ = [
    "Counter", "FlightRecorder", "Gauge", "LatencySummary",
    "MetricsRegistry", "Summary", "SpanContext", "Tracer", "adopt_trace",
    "aggregate", "aggregate_chrome", "annotate",
    "chrome_trace_from_journal", "compile_stats", "configure",
    "critical_path", "current_context", "current_ids", "current_span",
    "default_registry", "enabled", "event", "export", "export_chrome",
    "flight", "get_tracer", "identity", "install_from_env", "instrument",
    "metrics", "prometheus_text", "reset_metrics", "reset_tracer",
    "scan_run_dir", "serve_metrics", "snapshot", "span", "start_span",
    "timeline_report", "to_chrome_trace", "trace",
]


def snapshot() -> dict:
    """One JSON-able telemetry snapshot: the whole metrics registry and
    the tracer's accounting."""
    return {"metrics": default_registry().snapshot(),
            "trace": get_tracer().stats()}


def _site_family(metrics_d, count_metric, ms_metric):
    """(total count, total ms, per-site counts) for one count+ms
    metric-family pair out of a snapshot dict."""
    counts = (metrics_d.get(count_metric) or {}).get("values") or {}
    times = (metrics_d.get(ms_metric) or {}).get("values") or {}
    total_ms = 0.0
    for v in times.values():
        if isinstance(v, dict) and v.get("count"):
            if v.get("sum") is not None:
                total_ms += v["sum"]
            else:          # a snapshot without sums
                total_ms += v["count"] * (v.get("mean") or 0.0)
    return (int(sum(float(v) for v in counts.values())),
            round(total_ms, 1),
            {k.replace("site=", "", 1): int(v)
             for k, v in sorted(counts.items())})


def compile_stats(snap=None) -> dict:
    """Program-build accounting out of a snapshot (default: the live
    registry): total count, total ms and the per-site split; stored
    program loads (``aot_loads``) are a family of their own."""
    snap = snap if snap is not None else snapshot()
    metrics_d = snap.get("metrics", snap)
    compiles, total_ms, by_site = _site_family(
        metrics_d, instrument.COMPILE_COUNT_METRIC,
        instrument.COMPILE_MS_METRIC)
    aot_loads, aot_ms, aot_by_site = _site_family(
        metrics_d, instrument.AOT_LOAD_COUNT_METRIC,
        instrument.AOT_LOAD_MS_METRIC)
    return {"compiles": compiles, "total_ms": total_ms,
            "by_site": by_site,
            "aot_loads": aot_loads, "aot_load_ms": aot_ms,
            "aot_by_site": aot_by_site}
