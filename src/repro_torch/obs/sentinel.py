"""Online recall sentinel — accuracy watched in production, off-path.

The port of ``repro/obs/sentinel.py``.  Offline evaluation
(``repro_torch.eval``) answers "what recall does this routing config
achieve on a benchmark corpus"; nothing so far answers "what recall is the
fleet achieving on the traffic it is serving *right now*".  The sentinel closes that loop:

  1. **shadow-sample**: :meth:`RecallSentinel.observe` is called from
     ``IndexFleet.query`` with the batch it just answered; a dedicated
     RNG samples ``sample_rate`` of the queries and copies (query,
     served answer) into a bounded pending deque.  The serve path does
     nothing else — no re-execution, no extra device work — so served
     answers are **bit-identical** with sampling on or off (enforced by
     test).  The answer is already on the host when it is handed over:
     the hook adds no device work and no synchronisation.
  2. **re-execute exhaustively, off-path**: :meth:`drain` (run from the
     fleet engine's maintenance tick, or continuously via
     :meth:`start` on a worker thread) re-answers each sample with
     ``fleet.scan_exact`` — the lossless single-refine ground truth, one
     exhaustive ``refine_topk`` over a transient union of every store —
     and scores the *served* answer against it with the same tie-aware
     ``recall_at_k`` the offline harness uses.
  3. **feed back**: the running mean lands on the ``fleet.online_recall``
     gauge (Prometheus: ``repro_fleet_online_recall``), and each audit
     appends an ``audit_routing(record=True)``-style ``(scores,
     true_hits)`` trace to ``fleet.routing_traces`` — so
     ``calibrate_routing()`` can periodically re-learn the adaptive
     threshold from *production* traffic (``recalibrate_every``).

Samples whose fleet contents changed between serve and audit (inserts
landed in between) are discarded rather than scored against ground truth
the served answer never saw.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.obs.registry import REGISTRY, MetricsRegistry

__all__ = ["RecallSentinel", "SentinelSample"]


class SentinelSample:
    """One shadow-sampled query: what was served, frozen at serve time."""

    __slots__ = ("query", "k", "dist", "gid", "next_gid", "ts")

    def __init__(self, query, k, dist, gid, next_gid):
        self.query = query
        self.k = k
        self.dist = dist
        self.gid = gid
        self.next_gid = next_gid     # fleet content version at serve time
        self.ts = time.time()


class RecallSentinel:
    """Shadow-sampling recall monitor over one :class:`IndexFleet`.

    Args:
      fleet: the fleet to watch; the sentinel installs itself as
        ``fleet.sentinel`` (the ``IndexFleet.query`` hook point).
      sample_rate: fraction of served queries shadow-sampled (drawn from
        the sentinel's own RNG — the serve path's randomness, if any, is
        untouched).
      max_pending: bound on queries sampled but not yet audited; beyond
        it the oldest samples are dropped (sampling must never become
        backpressure).
      recalibrate_every: run ``fleet.calibrate_routing(target_recall)``
        after every N audited queries (0 = never — traces still
        accumulate for an explicit call).
      target_recall: the recall target handed to ``calibrate_routing``.
      seed: sampling RNG seed (``np.random.default_rng(seed)``, as in the
        JAX package, so both sample the same query indices).
      registry: metrics registry (None = process default) for the
        ``fleet.online_recall`` gauge and sample/audit counters.
    """

    def __init__(self, fleet, *, sample_rate: float = 0.02,
                 max_pending: int = 256, recalibrate_every: int = 0,
                 target_recall: float = 0.95, seed: int = 0,
                 registry: Optional[MetricsRegistry] = REGISTRY):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        self.fleet = fleet
        self.sample_rate = float(sample_rate)
        self.recalibrate_every = int(recalibrate_every)
        self.target_recall = float(target_recall)
        self._rng = np.random.default_rng(seed)
        self._pending: deque = deque(maxlen=int(max_pending))
        self._lock = threading.Lock()
        self._recall_sum = 0.0
        self._audits = 0
        self._since_recalibrate = 0
        self.last_threshold: Optional[float] = None
        label = getattr(fleet, "obs_label", "fleet")
        if registry is not None:
            self._gauge = registry.gauge("fleet.online_recall", fleet=label)
            self._samples_ctr = registry.counter("sentinel.samples",
                                                 fleet=label)
            self._audits_ctr = registry.counter("sentinel.audits",
                                                fleet=label)
        else:
            self._gauge = self._samples_ctr = self._audits_ctr = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        fleet.sentinel = self

    # -- serve-path hook (must stay cheap and side-effect-free) ------------
    def observe(self, queries: np.ndarray, k: int, dist: np.ndarray,
                gid: np.ndarray) -> None:
        """Shadow-sample one answered batch.  Called by
        ``IndexFleet.query`` after the answer is final; only copies —
        the arrays handed back to the caller are never touched."""
        if self.sample_rate <= 0.0 or len(queries) == 0:
            return
        picks = np.nonzero(self._rng.random(len(queries))
                           < self.sample_rate)[0]
        if not len(picks):
            return
        next_gid = self.fleet._next_gid
        with self._lock:
            for i in picks:
                self._pending.append(SentinelSample(
                    np.array(queries[i]), k, np.array(dist[i]),
                    np.array(gid[i]), next_gid))
        if self._samples_ctr is not None:
            self._samples_ctr.inc(len(picks))

    # -- off-path auditing -------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def drain(self, max_audits: int = 0) -> int:
        """Audit up to ``max_audits`` pending samples (0 = all).

        Returns the number audited.  Safe to call from the maintenance
        tick or a worker thread; never from inside ``fleet.query``.
        """
        done = 0
        while max_audits <= 0 or done < max_audits:
            with self._lock:
                if not self._pending:
                    break
                sample = self._pending.popleft()
            if self._audit_one(sample):
                done += 1
        return done

    def _audit_one(self, sample: SentinelSample) -> bool:
        fleet = self.fleet
        if fleet._next_gid != sample.next_gid:
            return False     # contents moved since serve time: stale truth
        from repro_torch.eval.metrics import recall_at_k   # lazy: avoids cycle
        from repro_torch.obs import TRACER
        with TRACER.span("sentinel.audit", k=sample.k):
            exact_d, exact_g = fleet.scan_exact(sample.query[None],
                                                sample.k)
            recall = recall_at_k(sample.gid[None], exact_g, sample.k,
                                 approx_dist=sample.dist[None],
                                 exact_dist=exact_d)
            self._record_routing_trace(sample.query, exact_g[0])
        with self._lock:
            self._recall_sum += recall
            self._audits += 1
            audits = self._audits
            mean = self._recall_sum / audits
            self._since_recalibrate += 1
            recal = self.recalibrate_every and \
                self._since_recalibrate >= self.recalibrate_every
            if recal:
                self._since_recalibrate = 0
        if self._gauge is not None:
            self._gauge.set(mean)
        if self._audits_ctr is not None:
            self._audits_ctr.inc()
        if recal and fleet.router is not None and fleet.routing_traces:
            self.last_threshold = \
                fleet.calibrate_routing(self.target_recall)
        return True

    def _record_routing_trace(self, query: np.ndarray,
                              exact_gid: np.ndarray) -> None:
        """One ``(router scores, per-shard true-hit counts)`` pair, the
        exact shape ``audit_routing(record=True)`` appends — production
        fuel for ``calibrate_routing``."""
        fleet = self.fleet
        router = fleet.router
        if router is None or not router.num_shards:
            return
        with fleet._lock:
            gid_sets = [s.global_ids for s in fleet.shards]
        scores = router.score(query[None])[0]
        valid = exact_gid[exact_gid >= 0]
        hits = np.array([int(np.isin(valid, g).sum()) for g in gid_sets],
                        np.int64)
        fleet.routing_traces.append((scores.copy(), hits))
        del fleet.routing_traces[:-fleet.MAX_ROUTING_TRACES]

    # -- worker thread -----------------------------------------------------
    def start(self, interval_s: float = 0.05) -> None:
        """Continuously drain on a daemon worker thread (the alternative
        to riding the engine's maintenance tick)."""
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()

        def _run():
            while not self._stop.is_set():
                if not self.drain(max_audits=8):
                    self._stop.wait(interval_s)

        self._worker = threading.Thread(target=_run,
                                        name="recall-sentinel", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=10)
            self._worker = None

    # -- reading -----------------------------------------------------------
    @property
    def online_recall(self) -> float:
        """Running mean recall over everything audited (1.0 before any
        audit — no evidence of loss yet)."""
        with self._lock:
            return self._recall_sum / self._audits if self._audits else 1.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"online_recall": self._recall_sum / self._audits
                    if self._audits else 1.0,
                    "audits": self._audits,
                    "pending": len(self._pending),
                    "sample_rate": self.sample_rate,
                    "last_threshold": self.last_threshold}
