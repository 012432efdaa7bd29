"""Observability plane of the port — registry, span tracer, device traces.

The counterpart of ``repro.obs`` for the modules ported so far: one
process-wide :class:`MetricsRegistry` (counters, gauges, log-bucketed
histograms with exact-count p50/p95/p99), one :class:`SpanTracer`
(context-manager spans with parent nesting in a bounded ring, plus
cross-thread trace propagation via :class:`TraceContext`), and opt-in
``torch.profiler`` capture.  The serving engine and the fleet record into
the module-level defaults ``REGISTRY`` / ``TRACER``; metric and span names
are the JAX package's.  Its flight recorder, recall sentinel and exporters
are not ported yet.
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, REGISTRY)
from repro_torch.obs.tracer import Span, SpanTracer, TraceContext, TRACER
from repro_torch.obs.profile import device_trace, trace_annotation

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "Span", "SpanTracer", "TraceContext", "TRACER",
           "device_trace", "trace_annotation"]
