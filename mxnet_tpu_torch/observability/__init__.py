"""mxnet_tpu_torch.observability — the metrics registry (counterpart of
``mxnet_tpu/observability``, of which the port has ``metrics`` so far):
counters, gauges and histogram summaries with labeled families, a
process-wide default registry and its Prometheus text. Span tracing,
the flight recorder, the exporters and the step-phase instrumentation
are ROADMAP Queue 1 item 13."""
from __future__ import annotations

from . import metrics
from .metrics import (Counter, Gauge, LatencySummary, MetricsRegistry,
                      Summary, default_registry, prometheus_text,
                      reset_metrics, snapshot)

__all__ = ["Counter", "Gauge", "LatencySummary", "MetricsRegistry",
           "Summary", "default_registry", "metrics", "prometheus_text",
           "reset_metrics", "snapshot"]
