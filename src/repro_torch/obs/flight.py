"""Flight recorder — tail-sampled full span trees for the requests that
matter, in a bounded ring with JSONL export.

A copy of the JAX package's ``repro/obs/flight.py`` (pure Python), kept in
the port so that it imports nothing of that package; the triggers, the
quantile gate and the ``flight.retained`` / ``flight.dropped`` counters are
the same.

The span ring (:class:`~repro_torch.obs.tracer.SpanTracer`) answers "what does
a typical request look like"; after a p99 spike the question is the
opposite — *what did the slow one do*.  Keeping every span tree is
unaffordable, so the recorder **tail-samples**: it taps every finished
span through a tracer listener, buffers them per ``trace_id``, and when a
*trigger* span completes (``serve.tick`` by default — the span that ends
a request's execution) it decides once whether the whole trace is worth
keeping:

  * the trigger's duration exceeds an explicit ``threshold_ms``, or —
    when no threshold is configured — the recorder's own running
    ``quantile`` of trigger durations (after ``min_samples`` warmup), or
  * the trace carries a typed error noted via :meth:`note_error`
    (``RETRY_LATER`` refusals, executor ``INTERNAL`` faults, …) — error
    notes also retain on the *admission* span so requests refused before
    ever reaching a tick still leave a readable trace.

Retained traces land in a bounded ring (oldest evicted) as full span
lists with the retention reason, exportable as JSONL (:meth:`jsonl`) or
over the admin plane's TRACES message.  ``FLIGHT`` is the process
default, tapping the default ``TRACER``.

Memory is bounded everywhere: at most ``max_open_traces`` in-progress
buffers of ``max_spans_per_trace`` spans each, plus ``capacity``
retained records.
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.registry import REGISTRY, Histogram, MetricsRegistry
from repro_torch.obs.tracer import Span, SpanTracer, TRACER

__all__ = ["FlightRecorder", "FLIGHT"]


class FlightRecorder:
    """Tail sampling over one tracer's finished spans.

    Args:
      tracer: the :class:`SpanTracer` to tap (attaches a listener).
      capacity: retained-trace ring size (oldest evicted).
      threshold_ms: explicit latency gate on the trigger span; None (the
        default) gates on the running ``quantile`` instead.
      quantile: tail fraction to keep when no threshold is set (0.99
        keeps roughly the slowest 1% of ticks).
      min_samples: trigger completions before the quantile gate arms —
        an empty histogram's quantile is 0 and would retain everything.
      triggers: span names whose completion closes a trace and runs the
        latency decision (default ``("serve.tick",)``).
      error_triggers: span names that retain a trace when it has a noted
        error even though no latency trigger ran — the admission span
        (so refusals like RETRY_LATER / QUOTA_EXCEEDED / BAD_REQUEST are
        recorded without ever reaching a tick) and the executor's
        ``net.fail`` marker (the tick's own spans close while the
        exception unwinds, before the server can note the error).
      registry: counts ``flight.retained`` / ``flight.dropped`` (None =
        the process default registry).
    """

    def __init__(self, tracer: SpanTracer, *, capacity: int = 64,
                 threshold_ms: Optional[float] = None,
                 quantile: float = 0.99, min_samples: int = 32,
                 triggers: Tuple[str, ...] = ("serve.tick",),
                 error_triggers: Tuple[str, ...] = ("net.admit",
                                                    "net.fail"),
                 max_open_traces: int = 256,
                 max_spans_per_trace: int = 512,
                 registry: Optional[MetricsRegistry] = REGISTRY):
        self.tracer = tracer
        self.capacity = int(capacity)
        self.threshold_ms = threshold_ms
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self.triggers = tuple(triggers)
        self.error_triggers = tuple(error_triggers)
        self.max_open_traces = int(max_open_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self._lock = threading.Lock()
        self._open: "OrderedDict[int, List[Span]]" = OrderedDict()
        self._errors: Dict[int, str] = {}
        self._records: deque = deque(maxlen=self.capacity)
        # private distribution of trigger durations — deliberately not a
        # registry metric: the quantile gate must not be reset by
        # benchmark reset_metrics() calls mid-flight
        self._lat = Histogram()
        self._retained = registry.counter("flight.retained") \
            if registry is not None else None
        self._dropped = registry.counter("flight.dropped") \
            if registry is not None else None
        tracer.add_listener(self._on_span)

    def close(self) -> None:
        """Detach from the tracer (tests building private recorders)."""
        self.tracer.remove_listener(self._on_span)

    # -- the tap -----------------------------------------------------------
    def note_error(self, trace_id: int, code: str) -> None:
        """Mark a trace as ending in a typed error; whichever trigger (or
        error-trigger) span of it finishes next retains the whole trace."""
        if not trace_id:
            return
        with self._lock:
            self._errors[trace_id] = code
            # bound like _open: a noted error whose trace never finishes
            # a trigger span must not leak
            while len(self._errors) > self.max_open_traces:
                self._errors.pop(next(iter(self._errors)))

    def _on_span(self, sp: Span) -> None:
        with self._lock:
            buf = self._open.get(sp.trace_id)
            if buf is None:
                buf = self._open[sp.trace_id] = []
                while len(self._open) > self.max_open_traces:
                    self._open.popitem(last=False)   # evict oldest trace
            if len(buf) < self.max_spans_per_trace:
                buf.append(sp)
            is_trigger = sp.name in self.triggers
            err = self._errors.get(sp.trace_id)
            if not is_trigger and not (err and sp.name
                                       in self.error_triggers):
                return
            reason = None
            if err is not None:
                reason = f"error:{err}"
            elif is_trigger:
                dur = sp.duration_ms
                self._lat.observe(dur)
                if self.threshold_ms is not None:
                    if dur >= self.threshold_ms:
                        reason = f"latency>{self.threshold_ms:g}ms"
                elif self._lat.count >= self.min_samples and \
                        dur >= self._lat.quantile(self.quantile) > 0.0:
                    reason = f"latency>p{self.quantile * 100:g}"
            spans = self._open.pop(sp.trace_id, [])
            self._errors.pop(sp.trace_id, None)
            if reason is None:
                if self._dropped is not None:
                    self._dropped.inc()
                return
            self._records.append({
                "trace_id": sp.trace_id, "reason": reason,
                "trigger": sp.name,
                "duration_ms": round(sp.duration_ms, 6),
                "ts": round(time.time(), 6),
                "spans": [s.to_dict()
                          for s in sorted(spans, key=lambda s: s.start)]})
        if self._retained is not None:
            self._retained.inc()

    # -- reading -----------------------------------------------------------
    def records(self, limit: int = 0) -> List[dict]:
        """Retained traces, oldest first (``limit`` keeps the newest N)."""
        with self._lock:
            recs = list(self._records)
        return recs[-limit:] if limit else recs

    def jsonl(self, limit: int = 0) -> str:
        """One retained trace per line — the slow-query log."""
        return "\n".join(json.dumps(r, sort_keys=True)
                         for r in self.records(limit)) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._open.clear()
            self._errors.clear()
            self._lat.reset()


#: Process default: taps ``TRACER``, keeps the p99 tail of ``serve.tick``
#: plus every trace that ends in a typed error.
FLIGHT = FlightRecorder(TRACER)
