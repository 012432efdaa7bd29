"""Process-wide metrics registry — counters, gauges, log-bucketed histograms.

A copy of the JAX package's ``repro/obs/registry.py`` (pure Python), kept
in the port so that it imports nothing of that package; names, buckets and
quantile rules are the same, so both packages report alike.

The serving planes (``repro_torch.serve``, ``repro_torch.fleet``) used to report only
means: ``EngineStats.queries_per_sec`` and three hand-timed ``stage_ms``
buckets.  Tail behaviour — the p99 a query sees while a background
compaction rebuilds the delta, or while the router mis-fans a hot tenant —
was invisible.  This module is the one process-wide sink every plane
records into:

  * :class:`Counter` — monotonically increasing totals (queries served,
    WAL bytes appended);
  * :class:`Gauge` — last-write-wins levels (queue depth, delta
    occupancy);
  * :class:`Histogram` — **log-bucketed** latency distributions with
    *exact-count* quantiles: every observation lands in a geometric
    bucket (default growth 5% per bucket), bucket counts are exact
    integers, and ``quantile(q)`` walks the cumulative counts to the
    exact rank — only the *value* is quantized, to at most half a bucket
    width (≈2.5% relative), never the rank.  Observed min/max are kept
    exactly, so the extreme quantiles clamp to real observations.

Everything is thread-safe: background compaction workers, the serving
loop, and exporter scrapes may interleave freely (each metric carries its
own lock; the registry lock only guards get-or-create and collector
registration).

Metrics are keyed by ``(name, labels)`` — ``registry.histogram(
"serve.latency_ms", loop="fleetengine0")`` — so per-engine / per-fleet
series coexist in one registry.  ``get-or-create`` semantics: asking for
the same key returns the same object, so call sites don't coordinate.

Pull-based sources register a **collector**: a zero-arg callable
returning ``{name: value}`` gauges at scrape time (or None to be
dropped).  ``EngineStats`` / ``FleetStats`` stay plain dataclasses — their
owners register weakref'd collectors exposing every scalar of
``snapshot()``, so the existing dict contract is untouched while the
exporters see the same numbers.

``REGISTRY`` is the process default; tests build private instances.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]


class Counter:
    """Monotonic counter.  ``inc`` is thread-safe; ``value`` is exact."""

    kind = "counter"
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins level (queue depth, occupancy)."""

    kind = "gauge"
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed histogram with exact-count quantiles.

    Buckets are geometric: bucket ``i`` covers ``[lo·g^i, lo·g^(i+1))``
    with growth factor ``g`` (default 1.05 → ≤2.5% relative error at the
    geometric bucket midpoint).  Values below ``lo`` (including ≤0) land
    in an underflow bucket represented by the exact observed minimum;
    values ≥ ``hi`` land in an overflow bucket represented by the exact
    maximum.  ``quantile`` uses the same rank convention as
    ``numpy.percentile`` (linear rank ``q·(n−1)``) over the exact bucket
    counts, then returns the bucket's geometric midpoint clamped to the
    exact observed ``[min, max]``.

    The default range ``[1e-3, 1e7]`` spans 1 µs to ~3 hours when
    observations are milliseconds — every latency this repo measures.

    >>> h = Histogram()
    >>> for v in (1.0, 2.0, 3.0, 4.0, 100.0):
    ...     h.observe(v)
    >>> h.count, h.min, h.max
    (5, 1.0, 100.0)
    >>> h.quantile(0.0) == 1.0 and h.quantile(1.0) == 100.0
    True
    >>> abs(h.quantile(0.5) - 3.0) / 3.0 < 0.025   # ≤ half a bucket off
    True
    """

    kind = "histogram"
    __slots__ = ("lo", "hi", "growth", "_log_g", "_nb", "_counts", "_lock",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, lo: float = 1e-3, hi: float = 1e7,
                 growth: float = 1.05):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(f"bad histogram shape lo={lo} hi={hi} "
                             f"growth={growth}")
        self.lo, self.hi, self.growth = lo, hi, growth
        self._log_g = math.log(growth)
        self._nb = int(math.ceil(math.log(hi / lo) / self._log_g))
        # [underflow] + nb log buckets + [overflow]
        self._counts = [0] * (self._nb + 2)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float, n: int = 1) -> None:
        """Record ``v`` ``n`` times (one lock for a tick of equal values)."""
        v = float(v)
        if v != v or n < 1:             # NaN: refuse silently-poisoned tails
            return
        if v < self.lo:
            idx = 0
        elif v >= self.hi:
            idx = self._nb + 1
        else:
            idx = 1 + min(int(math.log(v / self.lo) / self._log_g),
                          self._nb - 1)
        with self._lock:
            self._counts[idx] += n
            self._count += n
            self._sum += v * n
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def _bucket_value(self, idx: int) -> float:
        if idx == 0:
            return self._min
        if idx == self._nb + 1:
            return self._max
        return self.lo * self.growth ** (idx - 0.5)    # geometric midpoint

    def quantile(self, q: float) -> float:
        """Exact-rank quantile over the bucket counts (0 when empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        with self._lock:
            n = self._count
            if not n:
                return 0.0
            rank = q * (n - 1)
            if rank <= 0:               # extremes are tracked exactly
                return float(self._min)
            if rank >= n - 1:
                return float(self._max)
            cum = 0
            for idx, c in enumerate(self._counts):
                cum += c
                if cum > rank:
                    return float(min(max(self._bucket_value(idx),
                                         self._min), self._max))
            return float(self._max)

    def percentiles(self) -> Dict[str, float]:
        """The operator trio: ``{"p50": …, "p95": …, "p99": …}``."""
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (self._nb + 2)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf


LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, str]) -> LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Name+labels → metric, with get-or-create semantics.

    One instance (:data:`REGISTRY`) is the process default every serving
    plane records into; exporters (``repro.obs.export`` in the JAX package) read it back out.

    >>> reg = MetricsRegistry()
    >>> reg.counter("demo.requests", loop="e0").inc(2)
    >>> reg.counter("demo.requests", loop="e0").value   # same object back
    2
    >>> reg.gauge("demo.requests", loop="e0")   # same key, different kind
    Traceback (most recent call last):
        ...
    TypeError: metric 'demo.requests'{'loop': 'e0'} already registered \
as Counter, not Gauge
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[LabelKey, object] = {}
        self._collectors: List[Callable[[], Optional[Dict[str, float]]]] = []

    def _get_or_create(self, cls, name: str, labels: Dict[str, str],
                       *args, **kw):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(*args, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{dict(key[1])} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, *, lo: float = 1e-3, hi: float = 1e7,
                  growth: float = 1.05, **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, lo, hi, growth)

    def add_collector(
            self, fn: Callable[[], Optional[Dict[str, float]]],
            **labels) -> None:
        """Register a pull-based gauge source.

        ``fn()`` is called at scrape time and returns ``{name: value}``
        (exported as gauges under ``labels``) — or None, which
        unregisters it (the weakref idiom: closures over dead objects
        return None and disappear).
        """
        with self._lock:
            self._collectors.append((fn, dict(labels)))

    def metrics(self) -> Iterator[Tuple[str, Dict[str, str], object]]:
        """Stable-ordered ``(name, labels, metric)`` triples."""
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, labels), metric in items:
            yield name, dict(labels), metric

    def collected(self) -> Iterator[Tuple[str, Dict[str, str], float]]:
        """Evaluate every collector; drop the ones reporting None."""
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn, labels in collectors:
            vals = fn()
            if vals is None:
                dead.append(fn)
                continue
            for name in sorted(vals):
                yield name, labels, float(vals[name])
        if dead:
            with self._lock:
                self._collectors = [(f, l) for f, l in self._collectors
                                    if f not in dead]

    def snapshot(self) -> dict:
        """Stable JSON-ready view: every metric + collected gauges."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}

        def slot(name, labels):
            if not labels:
                return name
            inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            return f"{name}{{{inner}}}"

        for name, labels, metric in self.metrics():
            if metric.kind == "counter":
                out["counters"][slot(name, labels)] = metric.value
            elif metric.kind == "gauge":
                out["gauges"][slot(name, labels)] = metric.value
            else:
                h: Histogram = metric
                out["histograms"][slot(name, labels)] = {
                    "count": h.count, "sum": h.sum,
                    "min": h.min, "max": h.max, **h.percentiles()}
        for name, labels, value in self.collected():
            out["gauges"].setdefault(slot(name, labels), value)
        return out

    def reset(self) -> None:
        """Drop every metric and collector (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


#: The process-wide default registry (serving planes record here).
REGISTRY = MetricsRegistry()
