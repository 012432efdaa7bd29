"""FleetEngine — one serving engine over a whole IndexFleet.

The port of ``repro/fleet/engine.py``: the fixed-shape batched admission of
:class:`repro_torch.serve.ClimberEngine` (the shared
:class:`~repro_torch.serve.knn_engine.BatchedServingLoop`), with a tick that
runs ``IndexFleet.query`` — route → per-shard kNN → ``merge_topk`` — so one
engine serves every tenant's shard plus the streaming delta.

The engine also drives the fleet's lifecycle plane: every
``maintenance_every`` queue ticks it runs :meth:`maintenance` between
batches (a background compaction when the delta is at capacity, then the
merge/retirement policy), so index upkeep rides the serving loop without
blocking a query on an INX rebuild.  With ``sentinel_rate > 0`` it also
installs the online recall sentinel (:class:`repro_torch.obs.RecallSentinel`)
and audits a couple of its shadow samples after every queue tick.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.refine import PAD_DIST, resolve_use_kernel
from repro_torch.fleet.fleet import IndexFleet
from repro_torch.obs import TRACER
from repro_torch.serve import api
from repro_torch.serve.knn_engine import BatchedServingLoop


class FleetEngine(BatchedServingLoop):
    """Batched request serving across all shards of a fleet.

    Args:
      fleet: the IndexFleet to serve (it may keep ingesting between ticks).
      routing: ``"signature"``, ``"adaptive"`` or ``"exhaustive"``.
      variant: per-shard planner variant.
      mesh: attach a mesh (a :class:`~repro_torch.launch.DeviceMesh` or a
        device list, D slots) to the fleet, so sealed shards run in the
        mesh placement.
      placement: ``"host"``, ``"mesh"``, or None for the fleet default.
      maintenance_every: run :meth:`maintenance` after every Nth queue tick
        (0 = only when called).
      merge_policy: the :class:`~repro_torch.fleet.lifecycle.merge.MergePolicy`
        maintenance applies (None = the fleet's / the policy defaults).
      sentinel_rate / sentinel_recalibrate_every: the online recall
        sentinel's sampling rate (0 = off) and its recalibration period.

    These may instead arrive bundled in one :class:`api.ServingConfig` via
    ``config=``.
    """

    _CONFIG_KEYS = ("batch_size", "k", "routing", "variant", "use_kernel",
                    "fanout", "placement", "maintenance_every",
                    "merge_policy", "trace_ring", "sentinel_rate",
                    "sentinel_recalibrate_every")

    def __init__(self, fleet: IndexFleet, *,
                 config: Optional[api.ServingConfig] = None,
                 mesh=None, **kwargs):
        scfg = api.resolve_config(config, kwargs, self._CONFIG_KEYS)
        self.config = scfg
        if scfg.routing not in ("signature", "adaptive", "exhaustive"):
            raise ValueError(f"unknown routing mode {scfg.routing!r}")
        if mesh is not None:
            fleet.attach_mesh(mesh)
        fleet._resolve_placement(scfg.placement)  # fail fast when bad
        if scfg.trace_ring:
            TRACER.set_capacity(scfg.trace_ring)
        cfg = fleet.cfg.shard_cfg
        super().__init__(series_len=cfg.series_len,
                         batch_size=scfg.batch_size, k=scfg.k or cfg.k)
        self.fleet = fleet
        self.routing = scfg.routing
        self.variant = scfg.variant
        self.use_kernel = resolve_use_kernel(scfg.use_kernel, fleet.device)
        self.fanout = scfg.fanout
        self.placement = scfg.placement
        self.maintenance_every = scfg.maintenance_every
        self.merge_policy = scfg.merge_policy
        self.last_maintenance: dict = {"retired": [], "merged": []}
        # online recall sentinel: shadow-samples served queries and audits
        # them exhaustively on the _after_tick hook, off the latency path
        self.sentinel = None
        if scfg.sentinel_rate > 0.0:
            from repro_torch.obs.sentinel import RecallSentinel
            self.sentinel = RecallSentinel(
                fleet, sample_rate=scfg.sentinel_rate,
                recalibrate_every=scfg.sentinel_recalibrate_every)

    def tenant_load(self, tenant: str) -> float:
        """The tenant's share of the fleet's per-shard query load
        (``FleetStats.per_shard_queries``); 0.0 for unknown tenants."""
        loads = self.fleet.stats.per_shard_queries
        total = sum(loads.values())
        return loads.get(tenant, 0) / total if total else 0.0

    def reset_metrics(self) -> None:
        """Zero both the loop's and the underlying fleet's metrics."""
        super().reset_metrics()
        self.fleet.reset_metrics()

    def _execute(self, qbatch: np.ndarray, nlive: int):
        """One tick: fleet-query the live rows, pad results back out (the
        zero-padded tail rows are not executed)."""
        t0 = time.perf_counter()
        dist, gid, info = self.fleet.query(
            qbatch[:nlive], k=self.k, routing=self.routing,
            variant=self.variant, use_kernel=self.use_kernel,
            fanout=self.fanout, placement=self.placement)
        dt = time.perf_counter() - t0
        self.stats.plan_cache_hits += info.plan_cache_hits
        self.stats.plan_cache_misses += info.plan_cache_misses
        bs = self.batch_size
        d = np.full((bs, self.k), PAD_DIST, np.float32)
        g = np.full((bs, self.k), -1, np.int32)
        touched = np.zeros(bs, np.int64)
        scanned = np.zeros(bs, np.int64)
        d[:nlive], g[:nlive] = dist, gid
        touched[:nlive] = info.partitions_touched
        scanned[:nlive] = info.candidates_scanned
        return d, g, touched, scanned, dt

    # -- lifecycle upkeep -------------------------------------------------
    def maintenance(self) -> dict:
        """One lifecycle tick between serving batches: a background
        compaction when the delta is at capacity (non-blocking), then the
        merge/retirement policy.  Returns the maintenance report."""
        fleet = self.fleet
        with TRACER.span("fleet.maintenance"):
            if fleet.cfg.auto_compact and \
                    fleet.delta.occupancy >= max(fleet.cfg.delta_capacity,
                                                 fleet.delta.min_build):
                fleet.compact_async()
            self.last_maintenance = \
                fleet.maintenance(policy=self.merge_policy)
        return self.last_maintenance

    def _after_tick(self) -> None:
        if self.maintenance_every and \
                self.stats.ticks % self.maintenance_every == 0:
            self.maintenance()
        if self.sentinel is not None:
            # audit a couple of shadow samples between batches; queries
            # land faster than audits drain, so the sentinel's bounded
            # pending deque (not the serve path) absorbs the difference
            self.sentinel.drain(max_audits=2)
