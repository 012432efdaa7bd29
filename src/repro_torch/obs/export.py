"""Exporters — Prometheus text exposition, JSONL event log, JSON snapshot.

A copy of the JAX package's ``repro/obs/export.py`` (pure Python), kept in
the port so that it imports nothing of that package: the same registry
contents give the same page, byte for byte.

Three stable output formats over one :class:`~repro_torch.obs.registry.
MetricsRegistry` (and optionally a :class:`~repro_torch.obs.tracer.SpanTracer`):

  * :func:`to_prometheus` — the text exposition format scrapers ingest:
    counters as ``<name>_total``, gauges plain, histograms as summaries
    (``{quantile="0.5"}`` series plus ``_count`` / ``_sum``).  Metric
    names are prefixed ``repro_`` and sanitized (dots → underscores);
  * :func:`spans_jsonl` — finished spans as one JSON object per line
    (the structured event log; ``SpanTracer.attach_jsonl`` streams the
    same format continuously);
  * :func:`snapshot` — one stable JSON document (sorted keys, rounded
    floats) for benchmark artifacts and golden tests.

Doctest — the golden Prometheus format::

    >>> from repro_torch.obs.registry import MetricsRegistry
    >>> reg = MetricsRegistry()
    >>> reg.counter("demo.requests").inc(3)
    >>> reg.gauge("demo.queue_depth", loop="engine0").set(2.5)
    >>> print(to_prometheus(reg))
    # TYPE repro_demo_queue_depth gauge
    repro_demo_queue_depth{loop="engine0"} 2.5
    # TYPE repro_demo_requests_total counter
    repro_demo_requests_total 3
    <BLANKLINE>

Histograms expose exact counts and exact-rank quantiles::

    >>> for v in (1.0, 2.0, 3.0, 4.0):
    ...     reg.histogram("demo.latency_ms").observe(v)
    >>> page = to_prometheus(reg)
    >>> '# TYPE repro_demo_latency_ms summary' in page
    True
    >>> 'repro_demo_latency_ms_count 4' in page
    True
    >>> 'repro_demo_latency_ms_sum 10' in page
    True

And the JSON snapshot is stable (sorted keys) run over run::

    >>> snap = snapshot(reg)
    >>> sorted(snap) == ['counters', 'gauges', 'histograms']
    True
    >>> snap["counters"]["repro_demo_requests_total"]
    3
"""
from __future__ import annotations

import json
import re
from typing import Iterable, Optional

from repro_torch.obs.registry import MetricsRegistry, REGISTRY
from repro_torch.obs.tracer import Span

__all__ = ["to_prometheus", "spans_jsonl", "snapshot", "prom_name"]

_SAN = r"[^a-zA-Z0-9_:]"          # characters a Prometheus name may not hold
QUANTILES = (0.5, 0.95, 0.99)


def prom_name(name: str, prefix: str = "repro") -> str:
    """Sanitize a dotted metric name into a Prometheus identifier.

    >>> prom_name("serve.latency_ms")
    'repro_serve_latency_ms'
    """
    return re.sub(_SAN, "_", f"{prefix}_{name}" if prefix else name)


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def to_prometheus(registry: MetricsRegistry = REGISTRY,
                  prefix: str = "repro") -> str:
    """Render the registry as one Prometheus text-exposition page."""
    lines = []
    seen_types = set()

    def typeline(pname: str, kind: str) -> None:
        if pname not in seen_types:
            seen_types.add(pname)
            lines.append(f"# TYPE {pname} {kind}")

    for name, labels, metric in registry.metrics():
        if metric.kind == "counter":
            pname = prom_name(name, prefix) + "_total"
            typeline(pname, "counter")
            lines.append(f"{pname}{_labels(labels)} {_fmt(metric.value)}")
        elif metric.kind == "gauge":
            pname = prom_name(name, prefix)
            typeline(pname, "gauge")
            lines.append(f"{pname}{_labels(labels)} {_fmt(metric.value)}")
        else:                                   # histogram → summary
            pname = prom_name(name, prefix)
            typeline(pname, "summary")
            for q in QUANTILES:
                lines.append(f"{pname}{_labels(labels, {'quantile': q})} "
                             f"{_fmt(metric.quantile(q))}")
            lines.append(f"{pname}_count{_labels(labels)} {metric.count}")
            lines.append(f"{pname}_sum{_labels(labels)} {_fmt(metric.sum)}")
    for name, labels, value in registry.collected():
        pname = prom_name(name, prefix)
        typeline(pname, "gauge")
        lines.append(f"{pname}{_labels(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def spans_jsonl(spans: Iterable[Span]) -> str:
    """Finished spans as JSONL (one sorted-key JSON object per line)."""
    return "\n".join(json.dumps(s.to_dict(), sort_keys=True)
                     for s in spans) + "\n"


def snapshot(registry: MetricsRegistry = REGISTRY, *, tracer=None,
             prefix: str = "repro") -> dict:
    """One stable JSON document: metrics (+ optional recent span roots).

    Counter slots use the Prometheus naming (``_total`` suffix) so the
    two exporters agree on identity; floats round to 6 places so the
    document is byte-stable across equal states.
    """
    raw = registry.snapshot()

    def rename(slot: str, suffix: str = "") -> str:
        name, brace, labels = slot.partition("{")
        return prom_name(name, prefix) + suffix + brace + labels

    def rnd(v):
        return round(v, 6) if isinstance(v, float) else v

    out = {
        "counters": {rename(k, "_total"): rnd(v)
                     for k, v in raw["counters"].items()},
        "gauges": {rename(k): rnd(v) for k, v in raw["gauges"].items()},
        "histograms": {rename(k): {kk: rnd(vv) for kk, vv in h.items()}
                       for k, h in raw["histograms"].items()},
    }
    if tracer is not None:
        out["traces"] = [t for t in
                         (tracer.tree(r.trace_id) for r in tracer.roots())
                         if t is not None]
    return out
