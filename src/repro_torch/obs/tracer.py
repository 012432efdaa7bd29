"""Low-overhead span tracer — nested wall-time spans in a bounded ring.

A copy of the JAX package's ``repro/obs/tracer.py`` (pure Python), kept in
the port so that it imports nothing of that package; the span names and
the trace-context rules are the same.

A **span** is one named host-side wall-clock interval with parent/child
nesting: the query path opens ``serve.tick → fleet.query → fleet.plan /
fleet.refine / fleet.merge``, ingest opens ``fleet.insert → wal.append /
delta.scatter``, and the background compactor (its own thread) opens
``compact.seal → compact.build / compact.swap``.  Finished spans land in
a bounded ring buffer (old spans fall off; tracing never grows without
bound) and — when the tracer is bound to a
:class:`~repro_torch.obs.registry.MetricsRegistry` — each span's duration is
observed into a ``span.<name>`` histogram, so every span family gets
p50/p95/p99 for free.

Nesting is thread-local: each thread keeps its own open-span stack, so
the compaction worker's spans interleave with the serving thread's spans
in the ring (ordered by end time) without ever corrupting either tree.
A span's ``trace_id`` is the id of its thread's root span, which is what
groups one query tick's tree back together.

**Trace-context propagation** — a trace can cross a thread or a process
boundary explicitly:

  * :meth:`SpanTracer.current_context` exports the innermost open span
    as a :class:`TraceContext` (``trace_id`` + ``span_id``) — the handoff
    token a thread captures before enqueueing work for another;
  * :meth:`SpanTracer.adopt` installs a received context on the current
    thread, so spans opened inside the block join the *remote* trace
    (their ``trace_id`` is the adopted one, their parent the adopting
    span id) instead of rooting a fresh local trace;
  * :meth:`SpanTracer.mint_trace_id` draws a random 63-bit trace id for
    the *origin* of a cross-process trace (a client about to stamp a
    request), so ids minted in different processes never collide the way
    the per-process span-id counter would.

The JAX package's network plane uses exactly this: its client mints a trace id
around its RTT span, ships it on ``QueryRequest.trace_id``, and the
server adopts it at admission and again on the executor thread — so one
trace links ``net.rtt → net.admit → serve.tick → fleet.query →
per-shard refine/merge`` across threads and across the socket.

Overhead per span: two ``perf_counter`` calls, one dict, one deque
append, one histogram observe — nanoseconds against the
hundreds-of-microseconds stages it wraps (the bench-smoke acceptance
budget is ≤5% on the fleet qps cell; measured well under).

**Profiler ranges** — while :func:`repro_torch.obs.profile.device_trace`
captures, :attr:`SpanTracer.profiling` is set and every span also opens a
``torch.profiler.record_function`` range of its own name, so each span
lines up with the device operations launched inside it on the profiler's
clock.  Outside that capture a span opens no range; the check costs one
attribute read.

``TRACER`` is the process default, bound to the default registry.
"""
from __future__ import annotations

import itertools
import json
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.obs.registry import REGISTRY, Histogram, MetricsRegistry

__all__ = ["Span", "SpanTracer", "TraceContext", "TRACER"]


@dataclass(frozen=True)
class TraceContext:
    """The portable half of an open span: what crosses a boundary.

    ``trace_id`` groups the distributed trace; ``span_id`` is the span
    the receiver should parent under (0 = root of the remote trace, e.g.
    a client-minted context with no local span yet).  Both are plain ints
    so the pair rides any wire field or queue item unchanged.
    """

    trace_id: int
    span_id: int = 0


@dataclass
class Span:
    """One finished (or in-flight) named interval."""

    name: str
    span_id: int
    parent_id: Optional[int]            # None for a root span
    trace_id: int                       # span_id of the thread's root
    start: float                        # perf_counter seconds
    end: float = 0.0
    wall_start: float = 0.0             # epoch seconds (for the event log)
    thread: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def to_dict(self) -> dict:
        """JSON-ready view (one JSONL event-log line)."""
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "trace_id": self.trace_id,
                "ts": round(self.wall_start, 6),
                "duration_ms": round(self.duration_ms, 6),
                "thread": self.thread, "attrs": self.attrs}


class _Anchor:
    """A context adopted onto a thread's stack — parents like a span but
    is never recorded (the real parent lives on another thread/process)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class SpanTracer:
    """Context-manager spans, thread-local nesting, bounded ring buffer."""

    def __init__(self, capacity: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = capacity
        self.registry = registry
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._hists: Dict[str, Histogram] = {}
        self._jsonl = None                   # open file handle or None
        self._listeners: List[Callable[[Span], None]] = []
        # ring evictions are silent by design; the counter is not — it is
        # what tells an operator the ring is undersized for the load
        self._dropped = registry.counter("obs.spans_dropped") \
            if registry is not None else None
        # set by :func:`repro_torch.obs.profile.device_trace` for its block:
        # each span then also opens a profiler range of its name
        self.profiling = False

    # -- recording --------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def span(self, name: str, **attrs):
        """Open a nested span; yields the live :class:`Span` (its
        ``duration_ms`` is final after the block exits, so callers can
        reuse the measurement instead of timing twice)."""
        stack = self._stack()
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        sp = Span(name=name, span_id=sid,
                  parent_id=(parent.span_id or None) if parent else None,
                  trace_id=parent.trace_id if parent else sid,
                  start=time.perf_counter(), wall_start=time.time(),
                  thread=threading.current_thread().name, attrs=attrs)
        stack.append(sp)
        rng = _profiler_range(name) if self.profiling else None
        try:
            yield sp
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
            sp.end = time.perf_counter()
            stack.pop()
            self._finish(sp)

    def reset_histograms(self, names) -> None:
        """Zero the ``span.<name>`` histograms of ``names`` (a serving
        loop's window starts from empty span histograms)."""
        if self.registry is None:
            return
        for name in names:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = \
                    self.registry.histogram(f"span.{name}")
            h.reset()

    # -- trace-context propagation ----------------------------------------
    @staticmethod
    def mint_trace_id() -> int:
        """A random 63-bit trace id for the origin of a cross-process
        trace.  Span-id counters are per-process (two processes both count
        1, 2, 3…), so the id that *groups* a distributed trace must be
        drawn from a space where independent mints don't collide."""
        return random.getrandbits(63) | 1          # never 0 ("no trace")

    def current_context(self) -> Optional[TraceContext]:
        """Export the innermost open span (or adopted context) of this
        thread as a :class:`TraceContext`; None when nothing is open."""
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        return TraceContext(trace_id=top.trace_id, span_id=top.span_id)

    @contextmanager
    def adopt(self, ctx, span_id: int = 0):
        """Join a received trace on the current thread.

        ``ctx`` is a :class:`TraceContext` (or a bare ``trace_id`` int,
        with ``span_id`` as the parent span).  Spans opened inside the
        block carry the adopted ``trace_id`` and parent under the adopted
        ``span_id`` — exactly as if the remote parent were open on this
        thread.  ``ctx=None`` (or ``trace_id=0``) is a no-op, so call
        sites can adopt unconditionally.
        """
        if isinstance(ctx, TraceContext):
            trace_id, span_id = ctx.trace_id, ctx.span_id
        else:
            trace_id = int(ctx) if ctx is not None else 0
        if not trace_id:
            yield
            return
        stack = self._stack()
        stack.append(_Anchor(trace_id, span_id))
        try:
            yield
        finally:
            stack.pop()

    # -- capacity / listeners ---------------------------------------------
    def set_capacity(self, capacity: int) -> None:
        """Resize the ring in place, keeping the newest spans (the net
        server applies ``ServingConfig.trace_ring`` through this)."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            if capacity == self.capacity:
                return
            self._ring = deque(self._ring, maxlen=capacity)
            self.capacity = capacity

    def add_listener(self, fn: Callable[[Span], None]) -> None:
        """Call ``fn(span)`` after every span finishes (the flight
        recorder's tap).  Listeners run on the finishing thread, outside
        the ring lock; exceptions propagate to the span's opener."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _finish(self, sp: Span) -> None:
        with self._lock:
            dropped = len(self._ring) == self.capacity
            self._ring.append(sp)
            jsonl = self._jsonl
            listeners = list(self._listeners)
        if dropped and self._dropped is not None:
            self._dropped.inc()
        if self.registry is not None:
            h = self._hists.get(sp.name)
            if h is None:
                h = self._hists[sp.name] = \
                    self.registry.histogram(f"span.{sp.name}")
            h.observe(sp.duration_ms)
        if jsonl is not None:
            line = json.dumps(sp.to_dict(), sort_keys=True)
            with self._lock:
                if self._jsonl is not None:
                    self._jsonl.write(line + "\n")
                    self._jsonl.flush()
        for fn in listeners:
            fn(sp)

    # -- reading ----------------------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest-finished first."""
        with self._lock:
            return list(self._ring)

    def roots(self) -> List[Span]:
        return [s for s in self.spans() if s.parent_id is None]

    def trace(self, trace_id: int) -> List[Span]:
        """Every ring span of one trace, oldest-finished first — the flat
        view the flight recorder and the admin TRACES reply export (a
        distributed trace adopted from another process has no local root,
        so the flat list is the always-correct form)."""
        return [s for s in self.spans() if s.trace_id == trace_id]

    def tree(self, trace_id: int) -> Optional[dict]:
        """One trace as a nested dict: ``{"name", "duration_ms", "attrs",
        "children": […]}`` — children ordered by start time.  None when
        the trace (or its root) has fallen off the ring.  For a trace
        adopted from another process (no local span is the trace root)
        the earliest locally-parentless span anchors the tree."""
        spans = self.trace(trace_id)
        by_parent: Dict[Optional[int], List[Span]] = {}
        for s in spans:
            by_parent.setdefault(s.parent_id, []).append(s)

        def build(sp: Span) -> dict:
            kids = sorted(by_parent.get(sp.span_id, ()),
                          key=lambda s: s.start)
            return {"name": sp.name,
                    "duration_ms": round(sp.duration_ms, 6),
                    "attrs": sp.attrs,
                    "children": [build(k) for k in kids]}

        root = [s for s in spans if s.span_id == trace_id]
        if not root:        # adopted trace: anchor on an orphan span
            local = {s.span_id for s in spans}
            orphans = [s for s in spans
                       if s.parent_id is None or s.parent_id not in local]
            root = sorted(orphans, key=lambda s: s.start)[:1]
        return build(root[0]) if root else None

    def last_trace(self, name: Optional[str] = None) -> Optional[dict]:
        """The most recent complete trace (optionally: whose root span is
        named ``name``) as a nested tree."""
        for root in reversed(self.roots()):
            if name is None or root.name == name:
                return self.tree(root.trace_id)
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- structured event log --------------------------------------------
    def attach_jsonl(self, path) -> None:
        """Append every finished span to ``path`` as one JSON line each
        (the structured event log exporters tail)."""
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
            self._jsonl = open(path, "a", encoding="utf-8")

    def detach_jsonl(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def _profiler_range(name: str):
    """An entered ``torch.profiler.record_function`` range (torch is loaded
    whenever a profiler capture is active)."""
    from torch.profiler import record_function
    rng = record_function(name)
    rng.__enter__()
    return rng


#: The process-wide default tracer, bound to the default registry (every
#: span family gets a ``span.<name>`` latency histogram automatically).
TRACER = SpanTracer(registry=REGISTRY)
