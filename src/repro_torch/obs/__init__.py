"""Observability plane of the port — registry, span tracer, exporters.

The counterpart of ``repro.obs``: one process-wide :class:`MetricsRegistry`
(counters, gauges, log-bucketed histograms with exact-count p50/p95/p99),
one :class:`SpanTracer` (context-manager spans with parent nesting in a
bounded ring, plus cross-thread / cross-process trace propagation via
:class:`TraceContext`), the tail-sampling :class:`FlightRecorder` that keeps
full span trees for slow or failed requests, the online
:class:`RecallSentinel` that audits live routed queries against exhaustive
ground truth, the exporters (Prometheus text, JSONL event log, stable JSON
snapshot) and opt-in ``torch.profiler`` capture.  The serving planes record
into the module-level defaults ``REGISTRY`` / ``TRACER`` / ``FLIGHT``;
metric and span names are the JAX package's.
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, REGISTRY)
from repro_torch.obs.tracer import Span, SpanTracer, TraceContext, TRACER
from repro_torch.obs.flight import FlightRecorder, FLIGHT
from repro_torch.obs.sentinel import RecallSentinel
from repro_torch.obs.export import snapshot, spans_jsonl, to_prometheus
from repro_torch.obs.profile import device_trace, trace_annotation

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "Span", "SpanTracer", "TraceContext", "TRACER",
           "FlightRecorder", "FLIGHT", "RecallSentinel",
           "snapshot", "spans_jsonl", "to_prometheus",
           "device_trace", "trace_annotation"]
