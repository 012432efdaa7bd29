"""ClimberEngine — batched kNN serving over the CLIMBER index.

Requests are admitted into fixed-shape query batches: a tick always runs
``batch_size`` query rows, the tail zero-padded when fewer requests wait, and
its outputs dropped.  Planning and refine are row-independent, so a query's
answer does not depend on the batch it rides in — ``run`` equals per-query
``knn_query``.

The pipeline is staged featurize → plan → refine (three plain methods; the
JAX package jits each).  A plan depends only on the query's P4→ signature,
so the engine memoises compacted plan rows in a :class:`PlanCache` LRU keyed
on the signature; a tick whose live rows all hit skips planning.  Each
stage's wall time is summed into :class:`EngineStats`, with the card
synchronised before every clock read.

Observability (``repro_torch.obs``), as in the JAX package: every tick opens
a ``serve.tick`` span with ``query.featurize`` / ``query.plan`` /
``query.refine`` children, arrival-to-answer latencies land in the
``serve.latency_ms`` histogram and the queue length in the
``serve.queue_depth`` gauge (labelled per loop), and a weakref collector
exposes the :class:`EngineStats` rates.  :meth:`BatchedServingLoop._after_tick`
is the between-batches hook the fleet engine drives its upkeep from.

The network plane's hooks, as in the JAX package: :meth:`make_ticket`
validates a frozen request into a ticket counted against its tenant
(``tenant_inflight``) and carrying its trace context, :meth:`prepare_batch`
assembles a batch on the host, :meth:`execute_prepared` runs it (on the
server's executor thread) under the admitting trace, and
:meth:`fail_tickets` resolves a failed tick's tickets with a typed refusal.
The legacy mutable :class:`QueryRequest` still goes in through
:meth:`submit`, which warns once and writes the answer back into it.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import ClimberIndex
from repro_torch.core.query import (candidates_scanned, default_slot_budget,
                                    get_planner, plan as plan_queries)
from repro_torch.core.refine import dispatch_refine, resolve_use_kernel
from repro_torch.obs import REGISTRY, TRACER
from repro_torch.obs.tracer import TraceContext
from repro_torch.serve import api
from repro_torch.utils.device import synchronize

# distinguishes each loop's metric series in the process registry
_LOOP_SEQ = itertools.count()

# the mutable-QueryRequest adapter warns once per process, not per call
_LEGACY_SUBMIT_WARNED = False


class PlanCache:
    """LRU of per-query plan rows with lifetime hit/miss counters."""

    __slots__ = ("size", "hits", "misses", "_rows")

    def __init__(self, size: int):
        self.size = int(size)
        self.hits = 0
        self.misses = 0
        self._rows: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._rows)

    def get(self, key):
        """The cached row (refreshing LRU order) or None; counts the lookup."""
        row = self._rows.get(key)
        if row is None:
            self.misses += 1
            return None
        self.hits += 1
        self._rows.move_to_end(key)
        return row

    def put(self, key, row) -> None:
        """Insert or refresh a row, evicting LRU entries over capacity."""
        if self.size <= 0:
            return
        self._rows[key] = row
        self._rows.move_to_end(key)
        while len(self._rows) > self.size:
            self._rows.popitem(last=False)

    def clear(self) -> None:
        self._rows.clear()


@dataclasses.dataclass
class QueryRequest:
    """One kNN request: a raw series in, (dist, gid) + metrics out.

    .. deprecated::
        The *mutable* legacy request the engine writes answers back into.
        New code submits the frozen :class:`api.QueryRequest` through
        :meth:`BatchedServingLoop.submit_request` and reads the
        :class:`api.QueryResult` off the returned :class:`QueryTicket`;
        ``submit`` keeps accepting this class (one-time
        ``DeprecationWarning``).  ``repro_torch.serve.QueryRequest`` is the
        frozen one.
    """

    rid: int
    series: np.ndarray                       # [n] raw query series
    k: int = 0                               # 0 => engine default
    dist: Optional[np.ndarray] = None        # [k] ascending ED
    gid: Optional[np.ndarray] = None         # [k] record ids (−1 pad)
    metrics: Optional["QueryMetrics"] = None
    done: bool = False
    submitted_at: Optional[float] = None     # perf_counter at admission


class QueryTicket:
    """One in-flight admission: a frozen :class:`api.QueryRequest` paired
    with its outcome — an :class:`api.QueryResult` on success, an
    :class:`api.ErrorReply` on failure; ``done`` flips last.  Tickets are
    what the queue, the network server's admission buffers and its executor
    hand around; the frozen request is never mutated."""

    __slots__ = ("request", "series", "result", "done", "submitted_at",
                 "legacy", "conn", "trace")

    def __init__(self, request: api.QueryRequest, series: np.ndarray,
                 submitted_at: Optional[float] = None):
        self.request = request
        self.series = series               # validated float32 [n]
        self.result = None                 # QueryResult | ErrorReply
        self.done = False
        self.submitted_at = submitted_at \
            if submitted_at is not None else time.perf_counter()
        self.legacy: Optional[QueryRequest] = None   # write-back adapter
        self.conn = None                   # net server's delivery handle
        self.trace: Optional[TraceContext] = None    # admitting context

    @property
    def ok(self) -> bool:
        return self.done and isinstance(self.result, api.QueryResult)


@dataclasses.dataclass(frozen=True)
class QueryMetrics:
    partitions_touched: int    # distinct partitions the plan selected
    candidates_scanned: int    # records resident in those partitions
    latency_s: float           # wall time of the tick that served it
    batch_fill: float          # live fraction of that tick's batch


@dataclasses.dataclass
class EngineStats:
    """Aggregate over everything the engine has served."""

    queries: int = 0
    ticks: int = 0
    total_s: float = 0.0
    partitions_touched: float = 0.0          # running sums (means below)
    candidates_scanned: float = 0.0
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    featurize_s: float = 0.0                 # per-stage wall time, summed
    plan_s: float = 0.0
    refine_s: float = 0.0

    def observe(self, batch_metrics: List[QueryMetrics]) -> None:
        self.ticks += 1
        for m in batch_metrics:
            self.queries += 1
            self.partitions_touched += m.partitions_touched
            self.candidates_scanned += m.candidates_scanned
        if batch_metrics:
            self.total_s += batch_metrics[0].latency_s

    @property
    def queries_per_sec(self) -> float:
        return self.queries / self.total_s if self.total_s else 0.0

    @property
    def mean_partitions_touched(self) -> float:
        return self.partitions_touched / self.queries if self.queries else 0.0

    @property
    def mean_candidates_scanned(self) -> float:
        return self.candidates_scanned / self.queries if self.queries else 0.0

    @property
    def plan_cache_hit_rate(self) -> float:
        n = self.plan_cache_hits + self.plan_cache_misses
        return self.plan_cache_hits / n if n else 0.0

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["queries_per_sec"] = self.queries_per_sec
        d["mean_partitions_touched"] = self.mean_partitions_touched
        d["mean_candidates_scanned"] = self.mean_candidates_scanned
        d["plan_cache_hit_rate"] = self.plan_cache_hit_rate
        return d


class BatchedServingLoop:
    """Fixed-shape batch admission.

    Subclasses implement :meth:`_execute`, which serves one zero-padded
    ``[batch_size, series_len]`` tick and returns host arrays
    ``(dist, gid, partitions_touched, candidates_scanned, seconds)``.
    """

    def __init__(self, *, series_len: int, batch_size: int, k: int):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.series_len = series_len
        self.batch_size = batch_size
        self.k = k
        self.queue: List[QueryTicket] = []
        self.stats = EngineStats()
        # per-tenant in-flight admissions (the net server's quota hook);
        # finish/fail run on the executor thread, so counts take a lock
        self._tenant_lock = threading.Lock()
        self._tenant_inflight: Dict[str, int] = {}
        # registry wiring: a per-instance label keeps concurrent loops'
        # series apart; EngineStats keeps its dataclass shape and is
        # exposed through a weakref collector
        self.obs_label = f"{type(self).__name__.lower()}{next(_LOOP_SEQ)}"
        self.latency_hist = REGISTRY.histogram("serve.latency_ms",
                                               loop=self.obs_label)
        self.queue_gauge = REGISTRY.gauge("serve.queue_depth",
                                          loop=self.obs_label)
        ref = weakref.ref(self)

        def _collect():
            loop = ref()
            if loop is None:
                return None
            s = loop.stats
            return {"serve.queries": s.queries, "serve.ticks": s.ticks,
                    "serve.queries_per_sec": s.queries_per_sec,
                    "serve.plan_cache_hit_rate": s.plan_cache_hit_rate}

        REGISTRY.add_collector(_collect, loop=self.obs_label)

    def reset_metrics(self) -> None:
        """Zero this loop's aggregate stats and latency histogram."""
        self.stats = EngineStats()
        self.latency_hist.reset()

    def capture_device_trace(self, log_dir):
        """Opt-in ``torch.profiler`` capture of everything this loop runs
        inside the block (see :func:`repro_torch.obs.profile.device_trace`)."""
        from repro_torch.obs import device_trace
        return device_trace(log_dir)

    def _execute(self, qbatch: np.ndarray, nlive: int):
        raise NotImplementedError

    def _after_tick(self) -> None:
        """Hook run after each completed queue tick (between batches, off
        the per-query latency path); the fleet engine runs its lifecycle
        maintenance here."""

    def validate_series(self, series, rid: int = 0) -> np.ndarray:
        """A ``[series_len]`` float32 row or a ValueError."""
        series = np.asarray(series, dtype=np.float32)
        if series.shape != (self.series_len,):
            raise ValueError(f"request {rid}: series shape "
                             f"{series.shape} != ({self.series_len},)")
        return series

    def validate_k(self, k: int, rid: int = 0) -> None:
        if k > self.k:
            raise ValueError(f"request {rid}: k={k} exceeds the "
                             f"engine's static answer size k={self.k}")

    def make_ticket(self, req: api.QueryRequest) -> QueryTicket:
        """Validate a frozen request into an in-flight ticket (counted
        against its tenant's quota) without enqueueing it — the net
        server's admission buffers place tickets themselves.

        Trace handoff: a wire-carried context wins (cross-process), else
        the caller's open span is captured, so the executor thread's tick
        adopts the *admitting* context either way."""
        series = self.validate_series(req.series, req.request_id)
        self.validate_k(req.k, req.request_id)
        ticket = QueryTicket(req, series)
        if req.trace_id:
            ticket.trace = TraceContext(req.trace_id, req.parent_span_id)
        else:
            ticket.trace = TRACER.current_context()
        with self._tenant_lock:
            self._tenant_inflight[req.tenant] = \
                self._tenant_inflight.get(req.tenant, 0) + 1
        return ticket

    def tenant_inflight(self, tenant: str) -> int:
        """Admitted-but-unanswered requests of one tenant (quota hook)."""
        with self._tenant_lock:
            return self._tenant_inflight.get(tenant, 0)

    def _release_tenant(self, ticket: QueryTicket) -> None:
        with self._tenant_lock:
            t = ticket.request.tenant
            n = self._tenant_inflight.get(t, 0) - 1
            if n > 0:
                self._tenant_inflight[t] = n
            else:
                self._tenant_inflight.pop(t, None)

    # -- request-queue serving -------------------------------------------
    def submit_request(self, req: api.QueryRequest) -> QueryTicket:
        """Enqueue a frozen request; the ticket carries the result once a
        tick serves it."""
        ticket = self.make_ticket(req)
        self.queue.append(ticket)
        self.queue_gauge.set(len(self.queue))
        return ticket

    def submit(self, req: QueryRequest) -> QueryTicket:
        """Legacy adapter: enqueue a *mutable* :class:`QueryRequest`.

        Deprecated (one-time warning): wraps the request into the typed path
        and writes ``dist`` / ``gid`` / ``metrics`` / ``done`` back into the
        caller's object when the tick completes.
        """
        global _LEGACY_SUBMIT_WARNED
        if not _LEGACY_SUBMIT_WARNED:
            _LEGACY_SUBMIT_WARNED = True
            warnings.warn(
                "submit() with the mutable repro_torch.serve.knn_engine."
                "QueryRequest is deprecated; use submit_request(repro_torch."
                "serve.api.QueryRequest) and read the ticket's QueryResult",
                DeprecationWarning, stacklevel=2)
        series = self.validate_series(req.series, req.rid)
        self.validate_k(req.k, req.rid)
        req.series = series
        if req.submitted_at is None:
            req.submitted_at = time.perf_counter()
        ticket = QueryTicket(
            api.QueryRequest(series=series, k=req.k, request_id=req.rid),
            series, submitted_at=req.submitted_at)
        ticket.legacy = req
        ticket.trace = TRACER.current_context()
        with self._tenant_lock:
            self._tenant_inflight[""] = self._tenant_inflight.get("", 0) + 1
        self.queue.append(ticket)
        self.queue_gauge.set(len(self.queue))
        return ticket

    def prepare_batch(self, tickets: List[QueryTicket]) -> np.ndarray:
        """Validated tickets → one zero-padded ``[batch_size, n]`` batch —
        the host half of double buffering: the net server assembles batch
        N+1 here while its executor thread runs batch N."""
        if len(tickets) > self.batch_size:
            raise ValueError(f"{len(tickets)} tickets exceed "
                             f"batch_size={self.batch_size}")
        qbatch = np.zeros((self.batch_size, self.series_len), dtype=np.float32)
        for i, t in enumerate(tickets):
            qbatch[i] = t.series
        return qbatch

    @staticmethod
    def _batch_context(tickets: List[QueryTicket]):
        """The trace context one tick adopts: the first admitted ticket's,
        with the count of distinct trace ids in the batch (the tick span's
        ``traces`` attribute); each result still echoes its own trace id."""
        ids = {t.trace.trace_id for t in tickets if t.trace is not None}
        for t in tickets:
            if t.trace is not None:
                return t.trace, len(ids)
        return None, 0

    def execute_prepared(self, qbatch: np.ndarray,
                         tickets: List[QueryTicket]) -> int:
        """Run one pre-assembled tick and complete its tickets.

        The device half of double buffering, safe to call from a dedicated
        executor thread while the event loop keeps admitting: ``_execute``
        names its device and returns host arrays, so the answers are final
        when the tickets complete.  Raises whatever ``_execute`` raises; the
        caller decides whether to :meth:`fail_tickets`.  The tick span, the
        maintenance hook and anything it triggers adopt the admitting
        requests' trace context.
        """
        ctx, ntraces = self._batch_context(tickets)
        with TRACER.adopt(ctx):
            with TRACER.span("serve.tick", loop=self.obs_label,
                             live=len(tickets), traces=ntraces) as tick:
                dist, gid, touched, scanned, dt = \
                    self._execute(qbatch, len(tickets))
            self._finish_batch(tickets, dist, gid, touched, scanned, dt,
                               tick_span=tick)
            self._after_tick()
        return len(tickets)

    def fail_tickets(self, tickets: List[QueryTicket],
                     error: api.ErrorReply) -> None:
        """Resolve tickets with a typed refusal (executor fault paths)."""
        for t in tickets:
            t.result = dataclasses.replace(
                error, request_id=t.request.request_id)
            self._release_tenant(t)
            if t.legacy is not None:
                t.legacy.done = True
            t.done = True

    def _finish_batch(self, tickets: List[QueryTicket], dist, gid,
                      touched, scanned, dt: float, tick_span=None) -> None:
        """Complete one tick's tickets: typed results (echoing each
        ticket's trace id and the ``serve.tick`` span), the legacy
        write-back, tenant release, latency histogram and stats."""
        done_at = time.perf_counter()
        fill = len(tickets) / self.batch_size
        metrics = []
        for i, t in enumerate(tickets):
            req = t.request
            kq = req.k or self.k
            qm = QueryMetrics(partitions_touched=int(touched[i]),
                              candidates_scanned=int(scanned[i]),
                              latency_s=dt, batch_fill=fill)
            t.result = api.QueryResult(
                request_id=req.request_id, dist=dist[i, :kq], gid=gid[i, :kq],
                partitions_touched=qm.partitions_touched,
                candidates_scanned=qm.candidates_scanned,
                latency_ms=(done_at - t.submitted_at) * 1e3, batch_fill=fill,
                trace_id=t.trace.trace_id if t.trace is not None else 0,
                parent_span_id=tick_span.span_id
                if tick_span is not None else 0)
            if t.legacy is not None:      # thin adapter: mutate in place
                t.legacy.dist, t.legacy.gid = dist[i, :kq], gid[i, :kq]
                t.legacy.metrics = qm
                t.legacy.done = True
            self._release_tenant(t)
            t.done = True
            metrics.append(qm)
            self.latency_hist.observe(t.result.latency_ms)
        self.stats.observe(metrics)

    def step(self) -> int:
        """Serve one batch from the queue; returns #requests completed.
        Requests leave the queue only after their tick succeeded."""
        if not self.queue:
            return 0
        live = self.queue[:min(self.batch_size, len(self.queue))]
        qbatch = self.prepare_batch(live)
        ctx, ntraces = self._batch_context(live)
        with TRACER.adopt(ctx):
            with TRACER.span("serve.tick", loop=self.obs_label,
                             live=len(live), traces=ntraces) as tick:
                dist, gid, touched, scanned, dt = \
                    self._execute(qbatch, len(live))
            del self.queue[:len(live)]
            self.queue_gauge.set(len(self.queue))
            self._finish_batch(live, dist, gid, touched, scanned, dt,
                               tick_span=tick)
            self._after_tick()
        return len(live)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.step():
                return

    # -- direct batch API -------------------------------------------------
    def run(self, queries, k: int = 0
            ) -> Tuple[np.ndarray, np.ndarray, List[QueryMetrics]]:
        """Serve ``[Q, n]`` queries through fixed-shape ticks.

        Returns ``(dist [Q, k], gid [Q, k], metrics per query)``, equal to
        per-query :func:`repro_torch.core.query.knn_query` with the
        engine's variant and backend.
        """
        queries = np.asarray(queries, dtype=np.float32)
        kq = k or self.k
        if kq > self.k:
            raise ValueError(f"k={kq} exceeds the engine's static answer "
                             f"size k={self.k}; build the engine with a "
                             f"larger k")
        qn = queries.shape[0]
        if qn == 0:
            return (np.zeros((0, kq), np.float32),
                    np.full((0, kq), -1, np.int32), [])
        dists, gids, metrics = [], [], []
        for lo in range(0, qn, self.batch_size):
            chunk = queries[lo:lo + self.batch_size]
            nlive = chunk.shape[0]
            pad = self.batch_size - nlive
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, chunk.shape[1]), np.float32)])
            with TRACER.span("serve.tick", loop=self.obs_label, live=nlive):
                dist, gid, touched, scanned, dt = self._execute(chunk, nlive)
            for _ in range(nlive):           # direct API: no queue wait
                self.latency_hist.observe(dt * 1e3)
            dists.append(dist[:nlive, :kq])
            gids.append(gid[:nlive, :kq])
            batch_metrics = [
                QueryMetrics(partitions_touched=int(touched[i]),
                             candidates_scanned=int(scanned[i]),
                             latency_s=dt, batch_fill=nlive / self.batch_size)
                for i in range(nlive)]
            metrics.extend(batch_metrics)
            self.stats.observe(batch_metrics)
        return np.concatenate(dists), np.concatenate(gids), metrics


class ClimberEngine(BatchedServingLoop):
    """Batched, kernel-first kNN serving loop over one index.

    Args:
      index: a built :class:`ClimberIndex`; the engine runs on its device.
      batch_size: rows per tick.
      variant: registered planner name.
      k: default answer size (0 => ``cfg.k``).
      use_kernel: refine backend; None resolves by the store's device
        (the fused kernel on CUDA, the dense oracle on the CPU).
      max_slots: static slot budget for plan compaction (None => the
        lossless ``default_slot_budget`` unless ``cfg.query_max_slots``
        overrides it).
      plan_cache_size: LRU capacity of the signature→plan cache (0 = off).

    These may instead arrive bundled in one :class:`api.ServingConfig` via
    ``config=`` (exclusive with the individual keyword arguments).
    ``mesh=`` (the JAX package's sharded refine) is refused: the port's
    refine is single-device.
    """

    _CONFIG_KEYS = ("batch_size", "variant", "k", "use_kernel",
                    "max_slots", "plan_cache_size")

    def __init__(self, index: ClimberIndex, *,
                 config: Optional[api.ServingConfig] = None, mesh=None,
                 **kwargs):
        if mesh is not None:
            raise NotImplementedError("the port's engine is single-device")
        cfg = api.resolve_config(config, kwargs, self._CONFIG_KEYS)
        self.config = cfg
        get_planner(cfg.variant)             # fail fast on unknown variants
        super().__init__(series_len=index.cfg.series_len,
                         batch_size=cfg.batch_size, k=cfg.k or index.cfg.k)
        self.index = index
        self.device = index.device
        self.variant = cfg.variant
        self.use_kernel = resolve_use_kernel(cfg.use_kernel, self.device)
        max_slots = cfg.max_slots
        if max_slots is None:
            max_slots = index.cfg.query_max_slots
        if max_slots is None:
            max_slots = default_slot_budget(index, cfg.variant)
        self.max_slots = max_slots
        self.store = index.store
        self.plan_cache_size = cfg.plan_cache_size
        # signature bytes → (sel_part, sel_lo, sel_hi, touched, scanned) rows
        self._plan_cache = PlanCache(cfg.plan_cache_size)

    # -- the staged pipeline (featurize → plan → refine) -------------------
    def _featurize(self, qb: torch.Tensor) -> torch.Tensor:
        return self.index.featurize(qb)[0]

    def _plan(self, p4r: torch.Tensor):
        qp = plan_queries(self.index, p4r, variant=self.variant,
                          max_slots=self.max_slots)
        return (qp.sel_part, qp.sel_lo, qp.sel_hi, qp.partitions_touched(),
                candidates_scanned(qp, self.store))

    def _refine(self, queries, sel_part, sel_lo, sel_hi):
        return dispatch_refine(self.store, queries, sel_part, sel_lo, sel_hi,
                               self.k, use_kernel=self.use_kernel)

    def _plan_batch(self, p4r: torch.Tensor, nlive: int):
        """Plan a tick's batch through the signature LRU: all live rows
        cached → assemble the plan on the host; otherwise plan the whole
        batch and refresh every live row's entry."""
        if not self.plan_cache_size:
            return self._plan(p4r)
        cache = self._plan_cache
        p4_host = p4r.cpu().numpy()
        keys = [p4_host[i].tobytes() for i in range(nlive)]
        h0, m0 = cache.hits, cache.misses
        rows = [cache.get(kk) for kk in keys]
        self.stats.plan_cache_hits += cache.hits - h0
        self.stats.plan_cache_misses += cache.misses - m0
        if nlive and all(r is not None for r in rows):
            bs = self.batch_size
            mp = rows[0][0].shape[-1]
            sel_part = np.full((bs, mp), -1, np.int32)
            sel_lo = np.zeros((bs, mp), np.int32)
            sel_hi = np.zeros((bs, mp), np.int32)
            touched = np.zeros(bs, np.int64)
            scanned = np.zeros(bs, np.int64)
            for i, r in enumerate(rows):
                sel_part[i], sel_lo[i], sel_hi[i], touched[i], scanned[i] = r
            dev = self.device
            return (torch.as_tensor(sel_part, device=dev),
                    torch.as_tensor(sel_lo, device=dev),
                    torch.as_tensor(sel_hi, device=dev), touched, scanned)
        out = self._plan(p4r)
        sp, lo, hi, touched, scanned = (x.cpu().numpy() for x in out)
        for i, kk in enumerate(keys):
            cache.put(kk, (sp[i], lo[i], hi[i], touched[i], scanned[i]))
        return out

    def _execute(self, qbatch: np.ndarray, nlive: int):
        """One fixed-shape tick.  Returns host arrays + wall seconds."""
        dev = self.device
        t0 = time.perf_counter()
        qb = torch.as_tensor(qbatch, device=dev)
        with TRACER.span("query.featurize"):
            p4r = self._featurize(qb)
            synchronize(dev)
        t1 = time.perf_counter()
        with TRACER.span("query.plan", variant=self.variant):
            sel_part, sel_lo, sel_hi, touched, scanned = \
                self._plan_batch(p4r, nlive)
            synchronize(dev)
        t2 = time.perf_counter()
        with TRACER.span("query.refine"):
            dist, gid = self._refine(qb, sel_part, sel_lo, sel_hi)
            synchronize(dev)
        t3 = time.perf_counter()
        self.stats.featurize_s += t1 - t0
        self.stats.plan_s += t2 - t1
        self.stats.refine_s += t3 - t2
        to_np = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return (to_np(dist), to_np(gid), to_np(touched), to_np(scanned), t3 - t0)
