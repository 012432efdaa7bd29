"""IndexFleet — sharded multi-index serving with streaming ingest, on the card.

The port of ``repro/fleet/fleet.py``.  The fleet owns:

  * **sealed shards** — immutable :class:`repro_torch.core.ClimberIndex`
    instances keyed by tenant / time-range, each with a ``global_ids`` map
    from its local record ids to fleet-global ids;
  * a **router** (:class:`repro_torch.fleet.router.SignatureRouter`) that
    fans a query out to a shard subset scored on signature-prefix affinity,
    with exhaustive fan-out as the lossless fallback;
  * a **delta shard** that absorbs ``insert()`` batches through the
    assignment path (featurize → group → trie → partition scatter, in place
    in its store on the card) and is always queried;
  * ``compact()`` — seals the delta into an immutable shard by re-running
    the CLIMBER-INX build over its contents, global ids preserved.

Cross-shard fusion goes through :func:`repro_torch.core.merge_topk` with
global-id remapping; per-shard answers carry the
:data:`repro_torch.core.PAD_DIST` sentinel for missing slots.

Placement — where the sealed shards execute:

  * ``placement="host"`` — the oracle: a host loop runs each routed
    shard's featurize → plan → refine in turn;
  * ``placement="mesh"`` — the shards are laid out over a
    :class:`~repro_torch.launch.DeviceMesh` of D slots
    (:class:`repro_torch.fleet.placement.MeshFleetPlacement`): each slot
    runs featurize → descent → plan → refine → in-order merge for the
    shards it owns with no copy to the host in between, and the slots'
    answers fold in shard order on the lead device.  Both placements give
    the same answers bit for bit on any D: the device planner reproduces
    the host plans entry for entry, the refine is the same kernel over the
    same store and the merge order is the shards' order; the delta is
    merged last on both.

On both placements the answer accumulates on the fleet's device (global
ids remapped there, ``merge_topk`` there) and is copied to the host once,
when ``query`` returns.

Plans are memoised in a :class:`repro_torch.serve.knn_engine.PlanCache`
keyed on the placement epoch, which advances whenever the sealed shard set
or the mesh changes, so a hit never replays a plan of a retired layout.

Random draws.  ``jax.random`` cannot be reproduced, so every draw the
fleet makes goes through one injectable hook (:class:`FleetDraws`): a
shard build's sample and pivot indices as a pure function of
``(seed, fold, n_rec)`` — ``fold`` is the reference's (``len(shards) + 17``
for ``add_shard`` and a seal, ``1000 + merge_count`` for a merge, the
delta's occupancy for its rebuild, under ``cfg.seed + 1``) — and the
router's pivot indices.  The default seeds a CPU ``torch.Generator`` from
them, so the CPU and the card build the same fleet and a WAL replay after
a restart reproduces the delta's rebuild history.

Observability (``repro_torch.obs``): ``fleet.query`` spans with
``fleet.plan`` / ``fleet.refine`` / ``fleet.merge`` children, ingest's
``fleet.insert → wal.append / delta.scatter``, the compactor's
``compact.*`` spans, and the ``fleet.query_latency_ms``,
``fleet.compaction_ms`` and ``fleet.partitions_touched`` histograms
(labelled per fleet), all named as in the JAX package.

Lifecycle plane (``repro_torch.fleet.lifecycle``): the write-ahead log
(appended before the delta scatter, fsynced before ``insert`` returns),
shard snapshots and :meth:`IndexFleet.save` / :meth:`IndexFleet.open`,
background compaction and LSM-style merge/retirement
(:meth:`IndexFleet.maintenance`), as in the reference.

Online recall sentinel (:class:`repro_torch.obs.RecallSentinel`): when one
is installed as ``fleet.sentinel``, every ``query`` hands it the answer once
that answer is on the host, for off-path exhaustive audits; the hook only
copies host arrays, so served answers are bit-identical with it on or off.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import (ClimberIndex, PartitionStore,
                                    _route_full_dataset, build_index,
                                    build_store, require_dense, sample_size)
from repro_torch.core.query import (candidates_scanned, exhaustive_selection,
                                    knn_query, plan)
from repro_torch.core.refine import (PAD_DIST, dispatch_refine, merge_topk,
                                     refine)
from repro_torch.distributed.store import concat_stores
from repro_torch.fleet.router import SignatureRouter
from repro_torch.launch.mesh import as_mesh
from repro_torch.obs import REGISTRY, TRACER
from repro_torch.serve.knn_engine import PlanCache
from repro_torch.utils.config import ClimberConfig
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize

# distinguishes each fleet's metric series in the process registry
_FLEET_SEQ = itertools.count()


class FleetDraws:
    """The fleet's random draws, each a pure function of its arguments.

    :meth:`build` returns a shard build's ``(sample_idx, pivot_idx)`` for
    :func:`repro_torch.core.index.build_index`; :meth:`router` the router's
    pivot indices into its sample.  This default seeds a CPU
    ``torch.Generator`` from ``(seed, fold)``; a subclass may replay
    another package's draws (the parity tests replay
    ``jax.random.fold_in(PRNGKey(seed), fold)``).

    ``pivot_method`` picks how the fleet's builds and its router select
    pivots: ``"random"`` (``pivot_idx`` is ``[r]`` rows of the sample) or
    ``"maxmin"`` (farthest-point; ``pivot_idx`` is the single start row).
    """

    def __init__(self, pivot_method: str = "random"):
        if pivot_method not in ("random", "maxmin"):
            raise ValueError(f"unknown pivot selection method {pivot_method!r}")
        self.pivot_method = pivot_method

    def _pivots(self, g: torch.Generator, n: int, r: int):
        if self.pivot_method == "maxmin":
            return torch.randint(n, (), generator=g)
        return torch.randperm(n, generator=g)[:r]

    @staticmethod
    def _generator(*words: int) -> torch.Generator:
        state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
        return torch.Generator(device="cpu").manual_seed(int(state[0] >> 1))

    def build(self, seed: int, fold: int, n_rec: int, cfg: ClimberConfig):
        g = self._generator(seed, fold, 0)
        s = sample_size(n_rec, cfg)
        sample_idx = torch.randperm(n_rec, generator=g)[:s]
        return sample_idx, self._pivots(g, s, cfg.num_pivots)

    def router(self, seed: int, n_sample: int, r: int):
        return self._pivots(self._generator(seed, 0, 1), n_sample, r)


@dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs on top of the per-shard :class:`ClimberConfig`
    (the JAX package's fields and defaults, so a saved manifest opens in
    either package)."""

    shard_cfg: ClimberConfig
    fanout: int = 2                 # shards the router selects per query
    routing_threshold: float = 0.85  # score-mass cut for routing="adaptive"
    delta_capacity: int = 4096      # records the delta holds before sealing
    delta_pad: Optional[int] = None  # physical slots per delta partition
                                     # (None => shard_cfg.capacity)
    auto_compact: bool = True       # seal automatically at delta_capacity
    background_compaction: bool = False  # auto-compaction returns before the
                                         # rebuild finishes (ticket-based)
    plan_cache_size: int = 256      # LRU capacity of the per-query plan cache
    seed: int = 0


@dataclass
class ShardHandle:
    """One immutable member of the fleet."""

    key: str                        # tenant / time-range label
    index: ClimberIndex
    global_ids: np.ndarray          # [n_shard] local row -> global record id
    sealed: bool = True
    created_at: float = 0.0         # wall-clock seal/registration time
    _gids_dev: Optional[torch.Tensor] = field(default=None, repr=False,
                                              compare=False)

    @property
    def num_records(self) -> int:
        return int(self.global_ids.shape[0])

    def global_ids_on(self, device) -> torch.Tensor:
        """``global_ids`` as an int32 tensor on ``device`` (copied once)."""
        if self._gids_dev is None or self._gids_dev.device != torch.device(device):
            self._gids_dev = torch.as_tensor(self.global_ids, dtype=torch.int32,
                                             device=device)
        return self._gids_dev


@dataclass
class FleetStats:
    """Aggregate serving/ingest counters for the whole fleet."""

    queries: int = 0
    inserts: int = 0
    compactions: int = 0
    delta_rebuilds: int = 0
    delta_occupancy: int = 0
    routed_pairs: int = 0           # (query, shard) executions actually run
    exhaustive_pairs: int = 0       # what exhaustive fan-out would have run
    routing_audits: int = 0
    routing_overlap: float = 0.0    # running sum of audited precision
    compaction_ms: float = 0.0      # cumulative seal wall time (build+swap)
    wal_bytes: int = 0              # pending WAL bytes (frames not yet sealed)
    merges: int = 0                 # shard pairs merged by maintenance()
    retired_shards: int = 0         # shards aged out by maintenance()
    per_shard_queries: Dict[str, int] = field(default_factory=dict)
    per_shard_partitions: Dict[str, int] = field(default_factory=dict)

    def observe_shard(self, key: str, queries: int, partitions: int) -> None:
        self.per_shard_queries[key] = \
            self.per_shard_queries.get(key, 0) + queries
        self.per_shard_partitions[key] = \
            self.per_shard_partitions.get(key, 0) + partitions

    @property
    def routing_precision(self) -> float:
        return self.routing_overlap / self.routing_audits \
            if self.routing_audits else 1.0

    @property
    def fanout_savings(self) -> float:
        return 1.0 - self.routed_pairs / self.exhaustive_pairs \
            if self.exhaustive_pairs else 0.0

    def lifecycle_snapshot(self) -> dict:
        return {"compaction_ms": self.compaction_ms,
                "wal_bytes": self.wal_bytes,
                "merges": self.merges,
                "retired_shards": self.retired_shards}

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["routing_precision"] = self.routing_precision
        d["fanout_savings"] = self.fanout_savings
        return d


@dataclass
class FleetQueryInfo:
    """Per-query execution metrics of one fleet query call."""

    partitions_touched: np.ndarray   # [Q] summed over every shard executed
    candidates_scanned: np.ndarray   # [Q]
    routed_mask: np.ndarray          # [Q, S] sealed shards each query hit
    lifecycle: Optional[dict] = None  # FleetStats.lifecycle_snapshot()
    stage_ms: Optional[dict] = None   # wall-ms per stage: plan_ms, refine_ms
                                      # (on the stacked pass the whole device
                                      # program, planning included), merge_ms
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _to_global(gid: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Local record ids → fleet-global ids through ``table`` (pads stay -1),
    on ``gid``'s device."""
    return torch.where(gid >= 0, table[gid.clamp_min(0).long()], -1)


class DeltaShard:
    """Append-only ingest shard with capacity slack.

    Until ``num_pivots`` records exist it serves from a single-partition
    store by exact scan; from its first rebuild on it is a real
    ClimberIndex whose partitions have ``delta_pad`` physical slots, and an
    insert routes through the assignment path and scatters into free slots
    of the store on the card, in place.  A batch that overflows its target
    partition triggers a rebuild over the accumulated contents, drawn from
    ``draws.build(seed, occupancy, ...)``.  The accumulated rows stay on
    the host (``data``), as in the reference.
    """

    def __init__(self, cfg: ClimberConfig, *, device: torch.device,
                 draws: FleetDraws, pad: Optional[int] = None, seed: int = 0):
        self.cfg = cfg.replace(
            partition_pad=pad if pad is not None else cfg.capacity)
        if self.cfg.partition_pad == 0:
            raise ValueError("a delta shard inserts into pad slots: it takes a dense "
                             "PartitionStore, not the ragged layout (partition_pad=0)")
        self.device = device
        self._draws = draws
        self._seed = seed
        self.data = np.zeros((0, cfg.series_len), np.float32)
        self.global_ids = np.zeros((0,), np.int32)
        self.index: Optional[ClimberIndex] = None
        self.rebuilds = 0
        self.min_build = cfg.num_pivots
        self._gids_dev: Optional[torch.Tensor] = None

    @property
    def occupancy(self) -> int:
        return int(self.data.shape[0])

    # -- ingest -----------------------------------------------------------
    def insert(self, batch: np.ndarray, gids: np.ndarray) -> None:
        base = self.occupancy
        self.data = np.concatenate([self.data, batch], axis=0)
        self.global_ids = np.concatenate(
            [self.global_ids, gids.astype(np.int32)])
        self._gids_dev = None
        if self.index is None:
            if self.occupancy >= self.min_build:
                self._rebuild()
            return
        if not self._scatter(batch, base):
            self._rebuild()

    def _rebuild(self) -> None:
        n = self.occupancy
        sample_idx, pivot_idx = self._draws.build(self._seed, n, n, self.cfg)
        self.index = build_index(torch.from_numpy(self.data), self.cfg,
                                 device=self.device, sample_idx=sample_idx,
                                 pivot_idx=pivot_idx,
                                 pivot_method=self._draws.pivot_method)
        self.rebuilds += 1

    def _scatter(self, batch: np.ndarray, base: int) -> bool:
        """Route a batch through the index's assignment path and write its
        records into free partition slots, in place.  False = some
        partition is full (the caller rebuilds)."""
        idx = self.index
        store = require_dense(idx.store, "a delta shard's insert")
        x = torch.as_tensor(batch, device=self.device).float()
        part, rec_dfs = _route_full_dataset(x, idx.pivots, idx.centroid_onehot,
                                            idx.trie, idx.cfg)
        part = part.long()
        order = torch.argsort(part, stable=True)
        ps = part[order]
        added = torch.bincount(ps, minlength=store.num_partitions)
        within = torch.arange(len(ps), device=self.device) \
            - (torch.cumsum(added, 0) - added)[ps]
        slots = store.count[ps].long() + within
        if len(ps) and int(slots.max()) >= store.capacity:
            return False
        rows = x[order]
        store.data[ps, slots] = rows
        # build_store's arithmetic, so a later rebuild is bit-identical
        store.norms[ps, slots] = (rows.double() ** 2).sum(dim=-1).float()
        store.rec_dfs[ps, slots] = rec_dfs[order].to(torch.int32)
        store.rec_gid[ps, slots] = (base + order).to(torch.int32)
        store.count.add_(added.to(torch.int32))
        return True

    def take(self) -> Tuple[np.ndarray, np.ndarray]:
        """Hand the accumulated contents to compaction and reset."""
        out = (self.data, self.global_ids)
        self.data = np.zeros((0, self.cfg.series_len), np.float32)
        self.global_ids = np.zeros((0,), np.int32)
        self._gids_dev = None
        self.index = None
        return out

    def global_ids_on(self, device) -> torch.Tensor:
        """``global_ids`` on ``device``, copied again only after an insert."""
        if self._gids_dev is None:
            self._gids_dev = torch.as_tensor(self.global_ids, device=device)
        return self._gids_dev

    # -- query ------------------------------------------------------------
    def _bootstrap_store(self) -> PartitionStore:
        zeros = torch.zeros(self.occupancy, dtype=torch.int32,
                            device=self.device)
        return build_store(torch.from_numpy(self.data).to(self.device),
                           zeros, zeros, 1)

    def store(self) -> Optional[PartitionStore]:
        if not self.occupancy:
            return None
        return self.index.store if self.index is not None \
            else self._bootstrap_store()

    def query(self, queries: np.ndarray, k: int, *, variant: str,
              use_kernel: Optional[bool] = None):
        """(dist, gid_local) on the card and (touched, scanned) host
        arrays, or None when empty."""
        if not self.occupancy:
            return None
        q = torch.as_tensor(queries, device=self.device)
        if self.index is None:
            sel = torch.zeros((len(queries), 1), dtype=torch.int32,
                              device=self.device)
            dist, gid = refine(self._bootstrap_store(), q, sel, sel, sel + 1,
                               k, use_kernel=use_kernel)
            return (dist, gid, np.ones(len(queries), np.int64),
                    np.full(len(queries), self.occupancy, np.int64))
        dist, gid, qp = knn_query(self.index, q, k, variant=variant,
                                  use_kernel=use_kernel)
        return (dist, gid,
                _to_host(qp.partitions_touched()).astype(np.int64),
                _to_host(candidates_scanned(qp, self.index.store)).astype(np.int64))


@dataclass
class FrozenDelta:
    """A delta frozen for sealing: contents + the WAL segments backing it."""

    delta: DeltaShard
    frames: List[Tuple[np.ndarray, np.ndarray]]   # (gids, batch) in order
    segs: List[int]                               # WAL segments to drop
    fold: int                                     # build fold (shard count
                                                  # at freeze + 17)
    key: str                                      # sealed shard key

    @property
    def data(self) -> np.ndarray:
        return self.delta.data

    @property
    def global_ids(self) -> np.ndarray:
        return self.delta.global_ids


def _frame_nbytes(gids: np.ndarray, batch: np.ndarray) -> int:
    from repro_torch.fleet.lifecycle.wal import _HEADER
    return _HEADER.size + gids.size * 4 + batch.size * 4


class IndexFleet:
    """Several CLIMBER shards + a streaming delta behind one query surface.

    Args:
      cfg: fleet configuration.
      device: where the shards live and run (``None`` → ``cuda``, raising
        when there is no card; pass ``"cpu"`` for the plain path).
      mesh: a :class:`~repro_torch.launch.DeviceMesh` or a device list
        for the mesh placement (makes ``placement="mesh"`` the default);
        ``scan_exact`` also shards over it.
      storage_dir: attach durable storage (see :meth:`attach_storage`).
      draws: the random-draw hook (:class:`FleetDraws` by default).
    """

    DELTA_KEY = "__delta__"
    MAX_ROUTING_TRACES = 4096       # bound on recorded audit traces

    def __init__(self, cfg: FleetConfig, *, device: DeviceLike = None,
                 mesh=None, storage_dir=None,
                 draws: Optional[FleetDraws] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else FleetDraws()
        self.shards: List[ShardHandle] = []
        self.router: Optional[SignatureRouter] = None
        self.delta = self._new_delta()
        self.stats = FleetStats()
        self._next_gid = 0
        self._seal_count = 0
        self._merge_count = 0
        self.mesh = as_mesh(mesh)
        self._placement = None          # lazily built MeshFleetPlacement
        self._placement_epoch = 0       # bumps with every sealed-set change
        self._plan_cache = PlanCache(cfg.plan_cache_size)
        self.merge_policy = None        # default MergePolicy for maintenance
        # -- lifecycle state ----------------------------------------------
        self._lock = threading.RLock()
        self.wal = None                 # WriteAheadLog when storage attached
        self.storage_dir: Optional[Path] = None
        self._shard_dirs: Dict[str, str] = {}   # shard key -> snapshot slug
        self._frames: List[Tuple[np.ndarray, np.ndarray]] = []  # active delta
        self._delta_segs: List[int] = []        # WAL segments backing it
        self._sealing: Optional[DeltaShard] = None   # frozen mid-compaction
        self._sealing_frames: List[Tuple[np.ndarray, np.ndarray]] = []
        self._sealing_segs: List[int] = []
        self._seal_ticket = None        # in-flight CompactionTicket
        # -- observability ------------------------------------------------
        self.obs_label = f"fleet{next(_FLEET_SEQ)}"
        self.query_hist = REGISTRY.histogram("fleet.query_latency_ms",
                                             fleet=self.obs_label)
        self.compaction_hist = REGISTRY.histogram("fleet.compaction_ms",
                                                  fleet=self.obs_label)
        self.touched_hist = REGISTRY.histogram("fleet.partitions_touched",
                                               fleet=self.obs_label)
        # (scores, true-hit counts) pairs recorded by audit_routing(...,
        # record=True); SignatureRouter.learn_threshold consumes them
        self.routing_traces: List[Tuple[np.ndarray, np.ndarray]] = []
        # online recall sentinel (repro_torch.obs.RecallSentinel installs
        # itself here); query() hands it each answered batch
        self.sentinel = None
        ref = weakref.ref(self)

        def _collect():
            fleet = ref()
            if fleet is None:
                return None
            s = fleet.stats
            return {"fleet.queries": s.queries,
                    "fleet.inserts": s.inserts,
                    "fleet.compactions": s.compactions,
                    "fleet.delta_occupancy": s.delta_occupancy,
                    "fleet.wal_bytes": s.wal_bytes,
                    "fleet.routing_precision": s.routing_precision,
                    "fleet.fanout_savings": s.fanout_savings,
                    "fleet.shards": len(fleet.shards)}

        REGISTRY.add_collector(_collect, fleet=self.obs_label)
        if storage_dir is not None:
            self.attach_storage(storage_dir)

    def _new_delta(self) -> DeltaShard:
        return DeltaShard(self.cfg.shard_cfg, device=self.device,
                          draws=self.draws, pad=self.cfg.delta_pad,
                          seed=self.cfg.seed + 1)

    def reset_metrics(self) -> None:
        """Zero the aggregate stats and this fleet's histograms."""
        with self._lock:
            self.stats = FleetStats()
            self._refresh_gauges()
        self.query_hist.reset()
        self.compaction_hist.reset()
        self.touched_hist.reset()

    # -- stacked placement ------------------------------------------------
    def attach_mesh(self, mesh) -> None:
        """Enable the mesh placement on ``mesh`` (a
        :class:`~repro_torch.launch.DeviceMesh` or a device list of any
        length) and make it the default; the fleet is laid out lazily on
        the next ``placement="mesh"`` query.  The placement epoch advances,
        so no cached plan of the old layout is replayed."""
        with self._lock:
            self.mesh = as_mesh(mesh)
            self._invalidate_placement()

    def _invalidate_placement(self) -> None:
        """Drop the stacked layout and advance the placement epoch (lock
        held): every cached plan of the old layout is orphaned."""
        self._placement = None
        self._placement_epoch += 1

    def _resolve_placement(self, placement: Optional[str]) -> str:
        """``None`` → ``"mesh"`` when a mesh is attached, else ``"host"``."""
        if placement is None:
            return "mesh" if self.mesh is not None else "host"
        if placement not in ("host", "mesh"):
            raise ValueError(f"unknown placement {placement!r}; "
                             f"expected 'host' or 'mesh'")
        if placement == "mesh" and self.mesh is None:
            raise ValueError("placement='mesh' needs a mesh: pass mesh= at "
                             "construction or call attach_mesh()")
        return placement

    def _ensure_placement(self):
        from repro_torch.fleet.placement import MeshFleetPlacement
        if self._placement is None:
            self._placement = MeshFleetPlacement(self.mesh, self.shards)
        return self._placement

    # -- durable storage --------------------------------------------------
    def attach_storage(self, storage_dir) -> None:
        """Make the fleet durable under ``storage_dir``: open (or create) the
        write-ahead log, flush batches buffered before attachment, and save
        the fleet.  A WAL that already holds frames is refused (restore
        through :meth:`open`)."""
        from repro_torch.fleet.lifecycle.snapshot import save_fleet
        from repro_torch.fleet.lifecycle.wal import WriteAheadLog
        with self._lock:
            storage_dir = Path(storage_dir)
            if self.storage_dir is not None:
                if storage_dir != self.storage_dir:
                    raise ValueError(
                        f"fleet already attached to {self.storage_dir}; "
                        f"cannot re-attach to {storage_dir}")
                return
            wal = WriteAheadLog(storage_dir / "wal")
            if wal.replay():
                wal.close()
                raise ValueError(
                    f"{storage_dir} already holds WAL frames; use "
                    f"IndexFleet.open() to restore it")
            self.storage_dir = storage_dir
            self.wal = wal
            # the frozen delta's frames get their own (rolled) segment so
            # the segment <-> delta correspondence holds for the seal
            if self._sealing_frames:
                for g, b in self._sealing_frames:
                    self.wal.append(g, b)
                self._sealing_segs = [self.wal.roll()]
            for g, b in self._frames:
                self.wal.append(g, b)
            self._delta_segs = [self.wal.active_segment]
            save_fleet(self, storage_dir)

    def save(self, storage_dir=None) -> Path:
        """Persist the fleet (sealed-shard snapshots + manifest; the WAL is
        written at insert time).  ``storage_dir`` defaults to the attached
        directory; a fleet without one is attached first."""
        from repro_torch.fleet.lifecycle.snapshot import save_fleet
        with self._lock:
            if storage_dir is None:
                if self.storage_dir is None:
                    raise ValueError("no storage attached: pass a directory")
                storage_dir = self.storage_dir
            self.attach_storage(storage_dir)
            return save_fleet(self, Path(storage_dir))

    @classmethod
    def open(cls, storage_dir, *, device: DeviceLike = None, mesh=None,
             draws: Optional[FleetDraws] = None) -> "IndexFleet":
        """Restore a fleet saved under ``storage_dir`` (by either package).

        Sealed shards load from their snapshots (bit-exact arrays), the
        router restores verbatim, and the WAL tail replays batch for batch
        into a fresh delta, skipping frames whose global ids a sealed shard
        already covers.  With the same draw hook the restored delta's
        rebuild history, and so every answer, equals the never-stopped
        fleet's.
        """
        from repro_torch.fleet.lifecycle.snapshot import (load_router,
                                                          load_shard,
                                                          read_manifest)
        from repro_torch.fleet.lifecycle.wal import WriteAheadLog
        storage_dir = Path(storage_dir)
        _recover_wal_rebase(storage_dir)
        manifest = read_manifest(storage_dir)
        shard_cfg = ClimberConfig(**manifest["shard_cfg"])
        cfg = FleetConfig(shard_cfg=shard_cfg, **manifest["fleet"])
        fleet = cls(cfg, device=device, mesh=mesh, draws=draws)
        fleet._seal_count = int(manifest["seal_count"])
        fleet._merge_count = int(manifest["merge_count"])
        for entry in manifest["shards"]:
            handle = load_shard(storage_dir / "shards" / entry["dir"],
                                fleet.device)
            fleet.shards.append(handle)
            fleet._shard_dirs[handle.key] = entry["dir"]
        fleet.router = load_router(storage_dir, manifest, shard_cfg,
                                   fleet.device)
        fleet._next_gid = int(manifest["next_gid"])

        # replay the WAL tail in memory-frame mode; storage attaches after,
        # through an atomic rebase
        wal_dir = storage_dir / "wal"
        frames = []
        if wal_dir.exists():
            wal = WriteAheadLog(wal_dir)
            frames = wal.replay()
            wal.close()
        sealed = np.sort(np.concatenate(
            [s.global_ids for s in fleet.shards])) \
            if fleet.shards else np.zeros(0, np.int32)
        for _seg, gids, batch in frames:
            if len(sealed) and bool(np.isin(gids, sealed).all()):
                continue            # sealed before the crash; already durable
            with fleet._lock:
                fleet._log_frame(gids, batch)
                fleet._ingest(batch, gids)
                fleet._next_gid = max(fleet._next_gid, int(gids.max()) + 1) \
                    if len(gids) else fleet._next_gid
            fleet._maybe_auto_compact()
        fleet._attach_storage_rebased(storage_dir)
        return fleet

    def _attach_storage_rebased(self, storage_dir: Path) -> None:
        """Adopt ``storage_dir`` after a replay: save the manifest first
        (shards sealed during the replay), then atomically rewrite the WAL
        to hold exactly the frames still pending in the delta."""
        import shutil

        from repro_torch.fleet.lifecycle.snapshot import save_fleet
        from repro_torch.fleet.lifecycle.wal import WriteAheadLog
        with self._lock:
            self.storage_dir = storage_dir
            save_fleet(self, storage_dir)
            wal_dir = storage_dir / "wal"
            rebase = storage_dir / "wal.rebase"
            if rebase.exists():
                shutil.rmtree(rebase)
            wal = WriteAheadLog(rebase)
            for g, b in self._frames:
                wal.append(g, b)
            wal.close()
            old = storage_dir / "wal.old"
            if old.exists():
                shutil.rmtree(old)
            if wal_dir.exists():
                wal_dir.rename(old)
            rebase.rename(wal_dir)              # atomic publish
            if old.exists():
                shutil.rmtree(old)
            self.wal = WriteAheadLog(wal_dir)
            self._delta_segs = [self.wal.active_segment]
            self._refresh_gauges()

    # -- membership -------------------------------------------------------
    @property
    def total_records(self) -> int:
        with self._lock:
            sealed = sum(s.num_records for s in self.shards)
            frozen = self._sealing.occupancy if self._sealing else 0
            return sealed + frozen + self.delta.occupancy

    def _ensure_router(self, sample) -> None:
        """Build the reference pivots once ``num_pivots`` rows exist (until
        then queries fan out exhaustively)."""
        r = self.cfg.shard_cfg.num_pivots
        if self.router is None and len(sample) >= r:
            head = torch.as_tensor(sample[: max(4 * r, 256)],
                                   dtype=torch.float32, device=self.device)
            self.router = SignatureRouter.from_sample(
                head, self.cfg.shard_cfg,
                pivot_idx=self.draws.router(self.cfg.seed, len(head), r),
                pivot_method=self.draws.pivot_method)

    def _build_shard_index(self, data, fold: int) -> ClimberIndex:
        """Deterministic INX build for a fleet member (no lock needed);
        the card is synchronised before it returns."""
        n_rec = len(data)
        sample_idx, pivot_idx = self.draws.build(self.cfg.seed, fold, n_rec,
                                                 self.cfg.shard_cfg)
        index = build_index(torch.as_tensor(data), self.cfg.shard_cfg,
                            device=self.device, sample_idx=sample_idx,
                            pivot_idx=pivot_idx,
                            pivot_method=self.draws.pivot_method)
        synchronize(self.device)
        return index

    def add_shard(self, key: str, data,
                  global_ids: Optional[np.ndarray] = None) -> ShardHandle:
        """Build and register an immutable shard over ``data`` (``[N, n]``,
        a numpy array or a tensor, moved to the fleet's device).

        ``global_ids`` defaults to the next contiguous fleet-global range.
        """
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        with self._lock:
            if any(s.key == key for s in self.shards):
                raise ValueError(f"duplicate shard key {key!r}")
            if global_ids is None:
                global_ids = np.arange(
                    self._next_gid, self._next_gid + len(data),
                    dtype=np.int32)
            global_ids = np.asarray(global_ids, dtype=np.int32)
            if len(global_ids):
                self._next_gid = max(self._next_gid,
                                     int(global_ids.max()) + 1)
            fold = len(self.shards) + 17
        index = self._build_shard_index(data, fold)
        handle = ShardHandle(key=key, index=index, global_ids=global_ids,
                             created_at=time.time())
        with self._lock:
            self._ensure_router(data)
            self.shards.append(handle)
            self.router.register(key, self.router.summarize(data))
            self._invalidate_placement()
            self._persist_shard(handle)
        return handle

    def _persist_shard(self, handle: ShardHandle) -> None:
        """Snapshot one sealed shard + rewrite the manifest (lock held)."""
        if self.storage_dir is None:
            return
        from repro_torch.fleet.lifecycle.snapshot import (save_shard,
                                                          shard_slug,
                                                          write_manifest)
        slug = shard_slug(handle.key, set(self._shard_dirs.values()))
        save_shard(self.storage_dir / "shards" / slug, handle)
        self._shard_dirs[handle.key] = slug
        write_manifest(self, self.storage_dir)

    # -- streaming ingest -------------------------------------------------
    def _log_frame(self, gids: np.ndarray, batch: np.ndarray) -> None:
        """WAL append (the durability point, fsynced, strictly before the
        delta scatter) + the in-memory frame list."""
        with TRACER.span("wal.append", rows=len(gids),
                         durable=self.wal is not None):
            if self.wal is not None:
                self.wal.append(gids, batch)
            self._frames.append((gids, batch))

    def _ingest(self, batch: np.ndarray, gids: np.ndarray) -> None:
        """Apply one logged batch to the delta (lock held; shared by live
        inserts and WAL replay)."""
        with TRACER.span("delta.scatter", rows=len(batch)):
            before = self.delta.rebuilds
            self.delta.insert(batch, gids)
            self._ensure_router(self.delta.data)
            self.stats.delta_rebuilds += self.delta.rebuilds - before
        self.stats.inserts += len(batch)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        frozen = self._sealing.occupancy if self._sealing else 0
        self.stats.delta_occupancy = self.delta.occupancy + frozen
        self.stats.wal_bytes = sum(
            _frame_nbytes(g, b)
            for g, b in self._frames + self._sealing_frames)

    def _maybe_auto_compact(self) -> None:
        """Seal when the delta crosses capacity (called off the lock)."""
        if not self.cfg.auto_compact:
            return
        with self._lock:
            due = self.delta.occupancy >= max(self.cfg.delta_capacity,
                                              self.delta.min_build)
        if not due:
            return
        if self.cfg.background_compaction:
            self.compact_async()
        else:
            self.compact()

    def insert(self, batch) -> np.ndarray:
        """Append a ``[B, series_len]`` batch into the streaming delta.

        Returns the assigned fleet-global ids (``[B] int32``).  With storage
        attached the batch is in the write-ahead log, fsynced, before the
        delta scatter and before this returns, so an acknowledged insert
        survives a crash.  Records are visible to the next query on every
        placement.  At ``delta_capacity`` (with ``auto_compact``) the delta
        seals, off-thread under ``background_compaction``.

        Raises ValueError when the batch is not ``[B, series_len]``.
        """
        if torch.is_tensor(batch):
            batch = batch.cpu().numpy()
        batch = np.asarray(batch, dtype=np.float32)
        if batch.ndim != 2 or batch.shape[1] != self.cfg.shard_cfg.series_len:
            raise ValueError(f"insert batch shape {batch.shape} != "
                             f"[B, {self.cfg.shard_cfg.series_len}]")
        with TRACER.span("fleet.insert", rows=len(batch)):
            with self._lock:
                gids = np.arange(self._next_gid, self._next_gid + len(batch),
                                 dtype=np.int32)
                self._next_gid += len(batch)
                self._log_frame(gids, batch)
                self._ingest(batch, gids)
            self._maybe_auto_compact()
        return gids

    # -- compaction (freeze → build off-lock → swap) ----------------------
    def _next_seal_key(self) -> str:
        self._seal_count += 1
        while any(s.key == f"sealed:{self._seal_count}"
                  for s in self.shards):
            self._seal_count += 1
        return f"sealed:{self._seal_count}"

    def _freeze(self) -> Optional[FrozenDelta]:
        """Freeze the delta for sealing (lock held by the caller); a fresh
        delta takes over ingest and the WAL rolls.  None when the delta is
        empty; ValueError when it cannot build an index yet."""
        if self._sealing is not None:
            raise RuntimeError("a compaction is already in flight")
        if not self.delta.occupancy:
            return None
        if self.delta.occupancy < self.delta.min_build:
            raise ValueError(
                f"cannot compact {self.delta.occupancy} records: pivot "
                f"selection needs >= {self.delta.min_build}; keep inserting "
                f"or lower shard_cfg.num_pivots")
        frozen = FrozenDelta(delta=self.delta, frames=self._frames,
                             segs=list(self._delta_segs),
                             fold=len(self.shards) + 17,
                             key=self._next_seal_key())
        self._sealing = self.delta
        self._sealing_frames = self._frames
        self._sealing_segs = frozen.segs
        self.delta = self._new_delta()
        self._frames = []
        if self.wal is not None:
            self.wal.roll()
            self._delta_segs = [self.wal.active_segment]
        else:
            self._delta_segs = []
        self._refresh_gauges()
        return frozen

    def _finish_seal(self, frozen: FrozenDelta,
                     handle: ShardHandle) -> None:
        """Swap the sealed shard in atomically, then reclaim WAL space
        (snapshot before the swap; frozen segments dropped only after the
        manifest lists the new shard)."""
        from repro_torch.fleet.lifecycle.snapshot import save_shard, shard_slug
        with self._lock:
            storage = self.storage_dir
            slug = shard_slug(handle.key, set(self._shard_dirs.values())) \
                if storage is not None else None
        if storage is not None:             # the slow write, off the lock
            save_shard(storage / "shards" / slug, handle)
        with self._lock:
            if storage is None and self.storage_dir is not None:
                # attach_storage() raced the build: snapshot before the
                # segments it flushed are dropped below
                storage = self.storage_dir
                slug = shard_slug(handle.key, set(self._shard_dirs.values()))
                save_shard(storage / "shards" / slug, handle)
            self.shards.append(handle)
            self._ensure_router(frozen.data)
            self.router.register(handle.key,
                                 self.router.summarize(frozen.data))
            self._invalidate_placement()
            if storage is not None:
                from repro_torch.fleet.lifecycle.snapshot import write_manifest
                self._shard_dirs[handle.key] = slug
                write_manifest(self, storage)
            self._sealing = None
            self._sealing_frames = []
            segs, self._sealing_segs = self._sealing_segs, []
            self.stats.compactions += 1
            self._refresh_gauges()
        if self.wal is not None and segs:
            self.wal.drop(segs)

    def _abort_seal(self, frozen: FrozenDelta) -> None:
        """Undo a failed seal: replay the frozen and live frames into one
        live delta, so no buffered insert is lost."""
        with self._lock:
            frames = self._sealing_frames + self._frames
            restored = self._new_delta()
            for g, b in frames:
                restored.insert(b, g)
            self.delta = restored
            self._frames = frames
            self._delta_segs = self._sealing_segs + self._delta_segs
            self._sealing = None
            self._sealing_frames = []
            self._sealing_segs = []
            self._refresh_gauges()

    def compact(self) -> Optional[ShardHandle]:
        """Seal the delta into an immutable shard (full INX rebuild on a
        worker thread, waited for).  Returns the new ShardHandle, or None
        when the delta is empty; ValueError below ``num_pivots`` records."""
        ticket = self._seal_ticket
        if ticket is not None:
            ticket.wait()
        ticket = self.compact_async()
        return ticket.wait() if ticket is not None else None

    def compact_async(self):
        """Trigger a background seal; returns its
        :class:`~repro_torch.fleet.lifecycle.compactor.CompactionTicket`
        (or None when the delta is empty, or the in-flight ticket)."""
        from repro_torch.fleet.lifecycle.compactor import \
            start_background_compaction
        return start_background_compaction(self)

    # -- maintenance (LSM merge + retirement) -----------------------------
    def maintenance(self, policy=None, *, now: Optional[float] = None) -> dict:
        """One lifecycle tick: retire aged shards, merge small neighbours
        (:func:`repro_torch.fleet.lifecycle.merge.run_maintenance`)."""
        from repro_torch.fleet.lifecycle.merge import run_maintenance
        return run_maintenance(self, policy=policy, now=now)

    # -- query ------------------------------------------------------------
    def _query_sealed_host(self, shards, queries: np.ndarray, k: int,
                           mask: np.ndarray, variant: str,
                           use_kernel: Optional[bool],
                           best_d: torch.Tensor, best_g: torch.Tensor,
                           touched: np.ndarray, scanned: np.ndarray,
                           stage: dict, epoch: int) -> None:
        """The host-loop oracle: featurize → plan → refine per routed shard,
        driven shard by shard from the host and merged on the card in shard
        order (accumulators in place).  Plans are memoised per (shard,
        query) under ``("host", epoch, variant, shard slot, query bytes)``.
        Each refine and merge span ends with a synchronize, so the spans
        time the card's work."""
        cache = self._plan_cache if self.cfg.plan_cache_size else None
        dev = self.device
        for si, shard in enumerate(shards):
            qsel = np.nonzero(mask[:, si])[0]
            if not len(qsel):
                continue
            qj = torch.as_tensor(queries[qsel], device=dev)
            rows_t = torch.as_tensor(qsel, device=dev)
            with TRACER.span("fleet.plan", shard=shard.key) as sp_plan:
                keys = rows = None
                if cache is not None:
                    keys = [("host", epoch, variant, si,
                             queries[i].tobytes()) for i in qsel]
                    rows = [cache.get(kk) for kk in keys]
                if rows is not None and all(r is not None for r in rows):
                    sp_np, lo_np, hi_np, pt, sc = (np.stack(x) for x in zip(*rows))
                    sel_part, sel_lo, sel_hi = (torch.as_tensor(x, device=dev)
                                                for x in (sp_np, lo_np, hi_np))
                else:
                    p4r, _ = shard.index.featurize(qj)
                    qp = plan(shard.index, p4r, variant=variant)
                    sel_part, sel_lo, sel_hi = qp.sel_part, qp.sel_lo, qp.sel_hi
                    pt = _to_host(qp.partitions_touched()).astype(np.int64)
                    sc = _to_host(candidates_scanned(
                        qp, shard.index.store)).astype(np.int64)
                    if cache is not None:
                        sp_np, lo_np, hi_np = (_to_host(x) for x in
                                               (sel_part, sel_lo, sel_hi))
                        for i, kk in enumerate(keys):
                            cache.put(kk, (sp_np[i], lo_np[i], hi_np[i],
                                           pt[i], sc[i]))
            with TRACER.span("fleet.refine", shard=shard.key) as sp_ref:
                dist, gid = dispatch_refine(shard.index.store, qj, sel_part,
                                            sel_lo, sel_hi, k,
                                            use_kernel=use_kernel)
                synchronize(dev)
            with TRACER.span("fleet.merge", shard=shard.key) as sp_mrg:
                md, mg = merge_topk(best_d[rows_t], best_g[rows_t], dist,
                                    _to_global(gid, shard.global_ids_on(dev)), k)
                best_d[rows_t] = md
                best_g[rows_t] = mg
                synchronize(dev)
            stage["plan_ms"] += sp_plan.duration_ms
            stage["refine_ms"] += sp_ref.duration_ms
            stage["merge_ms"] += sp_mrg.duration_ms
            touched[qsel] += pt
            scanned[qsel] += sc
            self.stats.observe_shard(shard.key, len(qsel), int(pt.sum()))

    def _query_sealed_mesh(self, shards, pl, queries: np.ndarray, k: int,
                           mask: np.ndarray, variant: str,
                           use_kernel: Optional[bool],
                           best_d: torch.Tensor, best_g: torch.Tensor,
                           touched: np.ndarray, scanned: np.ndarray,
                           stage: dict, epoch: int) -> None:
        """The mesh pass: featurize → descent → plan → refine → merge for
        every shard on its slot (``MeshFleetPlacement.query``), routing as a
        plan mask; plan rows are memoised under ``(epoch, variant, query
        bytes)`` and a batch whose queries all hit runs the refine-only
        :meth:`MeshFleetPlacement.dispatch`.  Variants without a device
        planner plan on the host (:meth:`_query_sealed_mesh_hostplan`)."""
        if not pl.supports_device_planning(variant):
            self._query_sealed_mesh_hostplan(
                shards, pl, queries, k, mask, variant, use_kernel,
                best_d, best_g, touched, scanned, stage)
            return
        qn = len(queries)
        routed_t = np.zeros((pl.num_slots, qn), dtype=bool)
        routed_t[: len(shards)] = mask.T
        cache = self._plan_cache
        with TRACER.span("fleet.plan", path="mesh") as sp_plan:
            keys = [(epoch, variant, queries[i].tobytes()) for i in range(qn)]
            rows = [cache.get(kk) for kk in keys]
            all_hit = bool(qn) and all(r is not None for r in rows)
            if all_hit:
                sp, lo, hi, pt_all, sc_all = (np.stack(x, axis=1)
                                              for x in zip(*rows))
                spm = np.where(routed_t[:, :, None], sp, -1)
        stage["plan_ms"] += sp_plan.duration_ms
        if all_hit:
            with TRACER.span("fleet.refine", path="mesh") as sp_ref:
                dist, gid = pl.dispatch(queries, spm, lo, hi, k,
                                        use_kernel=use_kernel)
                synchronize(dist.device)
            stage["refine_ms"] += sp_ref.duration_ms
        else:
            # the stacked pass plans on the card, inseparably from refine
            with TRACER.span("fleet.refine", path="mesh",
                             fused=True) as sp_ref:
                dist, gid, sp, lo, hi, pt_all, sc_all = pl.query(
                    queries, routed_t, k, variant=variant,
                    use_kernel=use_kernel)
            stage["refine_ms"] += sp_ref.duration_ms
            with TRACER.span("fleet.plan", path="mesh") as sp_put:
                pt_all = pt_all.astype(np.int64)
                sc_all = sc_all.astype(np.int64)
                for i, kk in enumerate(keys):
                    cache.put(kk, (sp[:, i], lo[:, i], hi[:, i],
                                   pt_all[:, i], sc_all[:, i]))
            stage["plan_ms"] += sp_put.duration_ms
        best_d.copy_(dist)
        best_g.copy_(gid)
        for si, shard in enumerate(shards):
            routed = mask[:, si]
            if not routed.any():        # the host loop never runs it either
                continue
            touched += np.where(routed, pt_all[si], 0)
            scanned += np.where(routed, sc_all[si], 0)
            self.stats.observe_shard(shard.key, int(routed.sum()),
                                     int(pt_all[si][routed].sum()))

    def _query_sealed_mesh_hostplan(self, shards, pl, queries: np.ndarray,
                                    k: int, mask: np.ndarray, variant: str,
                                    use_kernel: Optional[bool],
                                    best_d: torch.Tensor, best_g: torch.Tensor,
                                    touched: np.ndarray, scanned: np.ndarray,
                                    stage: dict) -> None:
        """Host-planned stacked fan-out for variants with no device planner:
        plan per routed shard, stack the plans to ``[S, Q, MP]`` with
        routing as masked rows, and run the refine-only pass.  Never
        cached (plan widths depend on the batch here)."""
        qn = len(queries)
        qj = torch.as_tensor(queries, device=self.device)
        with TRACER.span("fleet.plan", path="mesh-hostplan") as sp_plan:
            plans = []
            for si, shard in enumerate(shards):
                if not mask[:, si].any():
                    plans.append(None)
                    continue
                p4r, _ = shard.index.featurize(qj)
                plans.append(plan(shard.index, p4r, variant=variant))
            if all(qp is None for qp in plans):
                return                  # nothing routed: accumulators stay PAD
            mp = max(int(qp.sel_part.shape[-1]) for qp in plans
                     if qp is not None)
            sp = np.full((pl.num_slots, qn, mp), -1, np.int32)
            lo = np.zeros((pl.num_slots, qn, mp), np.int32)
            hi = np.zeros((pl.num_slots, qn, mp), np.int32)
            for si, (shard, qp) in enumerate(zip(shards, plans)):
                if qp is None:
                    continue
                w = int(qp.sel_part.shape[-1])
                routed = mask[:, si]
                sp[si, :, :w] = np.where(routed[:, None], _to_host(qp.sel_part), -1)
                lo[si, :, :w] = _to_host(qp.sel_lo)
                hi[si, :, :w] = _to_host(qp.sel_hi)
                pt = _to_host(qp.partitions_touched()).astype(np.int64)
                touched += np.where(routed, pt, 0)
                scanned += np.where(routed, _to_host(candidates_scanned(
                    qp, shard.index.store)).astype(np.int64), 0)
                self.stats.observe_shard(shard.key, int(routed.sum()),
                                         int(pt[routed].sum()))
        stage["plan_ms"] += sp_plan.duration_ms
        with TRACER.span("fleet.refine", path="mesh-hostplan") as sp_ref:
            dist, gid = pl.dispatch(queries, sp, lo, hi, k,
                                    use_kernel=use_kernel)
            synchronize(dist.device)
        stage["refine_ms"] += sp_ref.duration_ms
        best_d.copy_(dist)
        best_g.copy_(gid)

    def _merge_delta_answer(self, delta: DeltaShard, queries: np.ndarray,
                            k: int, variant: str,
                            use_kernel: Optional[bool],
                            best_d: torch.Tensor, best_g: torch.Tensor,
                            touched: np.ndarray, scanned: np.ndarray):
        """Fold one delta's (frozen or live) answer into the accumulators,
        on the card; returns the updated (best_d, best_g)."""
        res = delta.query(queries, k, variant=variant, use_kernel=use_kernel)
        if res is None:
            return best_d, best_g
        dist, gid, dt, dsc = res
        md, mg = merge_topk(best_d, best_g, dist,
                            _to_global(gid, delta.global_ids_on(self.device)), k)
        touched += dt
        scanned += dsc
        self.stats.observe_shard(self.DELTA_KEY, len(queries), int(dt.sum()))
        return md, mg

    def query(self, queries, k: int = 0, *,
              routing: str = "signature", variant: str = "adaptive",
              use_kernel: Optional[bool] = None,
              fanout: Optional[int] = None,
              threshold: Optional[float] = None,
              placement: Optional[str] = None
              ) -> Tuple[np.ndarray, np.ndarray, FleetQueryInfo]:
        """Fan out, per-shard kNN, fuse with ``merge_topk``.

        Args:
          queries: ``[Q, n]`` raw query series (host array or tensor).
          k: answer size (0 ⇒ ``shard_cfg.k``).
          routing: ``"signature"`` (the ``fanout`` best-scoring shards),
            ``"adaptive"`` (per-query score mass: ``threshold``, else the
            router's learned threshold, else ``cfg.routing_threshold``;
            ``fanout`` caps it) or ``"exhaustive"``.  The delta always runs.
          variant: per-shard planner; ``"exhaustive"`` with exhaustive
            routing is brute force over the fleet.
          use_kernel: refine backend (None: the kernel on the card, the
            dense path on the CPU).
          placement: ``"host"``, ``"mesh"`` (needs an attached mesh) or
            None (``"mesh"`` when a mesh is attached).  Both give the same
            answers bit for bit.

        Returns:
          (dist ``[Q, k]`` ascending ED, gid ``[Q, k]`` fleet-global ids,
          info), host arrays; ``PAD_DIST`` / ``-1`` past the candidates.
        """
        if routing not in ("signature", "adaptive", "exhaustive"):
            raise ValueError(f"unknown routing mode {routing!r}")
        placement = self._resolve_placement(placement)
        if torch.is_tensor(queries):
            queries = queries.cpu().numpy()
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError(f"queries must be [Q, n], got {queries.shape}")
        k = k or self.cfg.shard_cfg.k
        qn = len(queries)
        # the answer accumulates on the card; one copy to the host at the end
        best_d = torch.full((qn, k), PAD_DIST, dtype=torch.float32,
                            device=self.device)
        best_g = torch.full((qn, k), -1, dtype=torch.int32, device=self.device)
        touched = np.zeros(qn, np.int64)
        scanned = np.zeros(qn, np.int64)
        stage = {"plan_ms": 0.0, "refine_ms": 0.0, "merge_ms": 0.0}

        with TRACER.span("fleet.query", placement=placement,
                         queries=qn) as sp_root:
            # a consistent view under the lock; the sealed shards (immutable)
            # then run off it
            with self._lock:
                shards = list(self.shards)
                sealing = self._sealing
                delta = self.delta
                s = len(shards)
                pl = self._ensure_placement() \
                    if placement == "mesh" and s else None
                epoch = self._placement_epoch
                cache = self._plan_cache
                h0, m0 = cache.hits, cache.misses
                lifecycle = self.stats.lifecycle_snapshot()
                if routing == "exhaustive" or self.router is None or s == 0:
                    mask = np.ones((qn, s), dtype=bool)
                elif routing == "adaptive":
                    th = threshold
                    if th is None:
                        th = self.router.threshold
                    if th is None:
                        th = self.cfg.routing_threshold
                    mask = self.router.route_adaptive(
                        queries, float(th), max_fanout=fanout)
                else:
                    mask = self.router.route(queries,
                                             fanout or self.cfg.fanout)

            if s:
                run = self._query_sealed_mesh if placement == "mesh" \
                    else self._query_sealed_host
                args = (shards, pl) if placement == "mesh" else (shards,)
                run(*args, queries, k, mask, variant, use_kernel, best_d,
                    best_g, touched, scanned, stage, epoch)

            with TRACER.span("fleet.merge", shard=self.DELTA_KEY) as sp_mrg:
                if sealing is not None:   # frozen mid-compaction: immutable
                    best_d, best_g = self._merge_delta_answer(
                        sealing, queries, k, variant, use_kernel,
                        best_d, best_g, touched, scanned)
                with self._lock:          # live delta: serialised vs inserts
                    best_d, best_g = self._merge_delta_answer(
                        delta, queries, k, variant, use_kernel,
                        best_d, best_g, touched, scanned)
                    self.stats.queries += qn
                    self.stats.routed_pairs += int(mask.sum())
                    self.stats.exhaustive_pairs += qn * s
                synchronize(self.device)
            stage["merge_ms"] += sp_mrg.duration_ms
            best_d, best_g = _to_host(best_d), _to_host(best_g)
        self.query_hist.observe(sp_root.duration_ms)
        for t in touched:
            self.touched_hist.observe(float(t))
        if self.sentinel is not None:
            # shadow-sampling copies (query, answer) pairs of the host
            # arrays aside for the off-path audit; it never mutates them,
            # so served answers are bit-identical with sampling on or off
            self.sentinel.observe(queries, k, best_d, best_g)
        return best_d, best_g, FleetQueryInfo(
            partitions_touched=touched, candidates_scanned=scanned,
            routed_mask=mask, lifecycle=lifecycle, stage_ms=stage,
            plan_cache_hits=cache.hits - h0,
            plan_cache_misses=cache.misses - m0)

    def _union_store(self) -> Optional[PartitionStore]:
        """Every sealed, sealing and live delta store fused into one union
        store with fleet-global ids (``concat_stores``; a transient copy),
        or None when the fleet holds no record."""
        with self._lock:
            stores = [s.index.store for s in self.shards]
            gid_maps = [s.global_ids for s in self.shards]
            for delta in (self._sealing, self.delta):
                if delta is None:
                    continue
                dstore = delta.store()
                if dstore is not None:
                    # the live delta scatters in place: copy it under the lock
                    stores.append(PartitionStore(*(x.clone() for x in dstore)))
                    gid_maps.append(delta.global_ids)
        return concat_stores(stores, gid_maps) if stores else None

    def scan_exact(self, queries, k: int = 0, *,
                   use_kernel: Optional[bool] = None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact kNN as ONE refine over the union store (every shard and
        delta store, global ids remapped, fused by ``concat_stores``) —
        equal to exhaustive routing + the exhaustive variant.  The union is
        a transient copy of every store.  ``mesh`` (default: the attached
        mesh, if any) shards the union's partition axis over its slots
        (``refine_sharded``), with the same answer bit for bit.  Returns
        ``(dist, gid)`` host arrays with the ``PAD_DIST`` / ``-1``
        sentinel."""
        if torch.is_tensor(queries):
            queries = queries.cpu().numpy()
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        k = k or self.cfg.shard_cfg.k
        union = self._union_store()
        if union is None:
            return (np.full((len(queries), k), PAD_DIST, np.float32),
                    np.full((len(queries), k), -1, np.int32))
        sel, lo, hi = exhaustive_selection(union.num_partitions, len(queries),
                                           self.device)
        mesh = self.mesh if mesh is None else as_mesh(mesh)
        dist, gid = dispatch_refine(union, torch.as_tensor(queries, device=self.device),
                                    sel, lo, hi, k, mesh=mesh,
                                    use_kernel=use_kernel)
        return _to_host(dist), _to_host(gid)

    def audit_routing(self, queries, k: int = 0, *,
                      variant: str = "adaptive",
                      record: bool = False) -> float:
        """Routed-mode precision against the exhaustive oracle: the mean
        fraction of the exhaustive fan-out's answers the routed fan-out also
        returned (folded into ``stats.routing_precision``).  ``record=True``
        also appends one ``(scores, true_hits)`` trace per query to
        ``routing_traces`` for :meth:`calibrate_routing`."""
        k = k or self.cfg.shard_cfg.k
        _, g_routed, _ = self.query(queries, k, routing="signature",
                                    variant=variant)
        _, g_full, _ = self.query(queries, k, routing="exhaustive",
                                  variant=variant)
        overlaps = []
        for gr, gf in zip(g_routed, g_full):
            truth = set(int(x) for x in gf if x >= 0)
            if not truth:
                continue
            got = set(int(x) for x in gr if x >= 0)
            overlaps.append(len(got & truth) / len(truth))
        precision = float(np.mean(overlaps)) if overlaps else 1.0
        self.stats.routing_audits += 1
        self.stats.routing_overlap += precision
        if record and self.router is not None and self.router.num_shards:
            with self._lock:
                gid_sets = [s.global_ids for s in self.shards]
            scores = self.router.score(np.asarray(queries, np.float32))
            for i, gf in enumerate(g_full):
                valid = gf[gf >= 0]
                hits = np.array([int(np.isin(valid, g).sum())
                                 for g in gid_sets], np.int64)
                self.routing_traces.append((scores[i].copy(), hits))
            del self.routing_traces[:-self.MAX_ROUTING_TRACES]
        return precision

    def calibrate_routing(self, target_recall: float = 0.95) -> float:
        """Learn the adaptive-routing threshold from the recorded audit
        traces and install it on the router; returns it."""
        if self.router is None:
            raise RuntimeError("fleet has no router to calibrate")
        if not self.routing_traces:
            raise RuntimeError("no routing traces recorded — call "
                               "audit_routing(..., record=True) first")
        return self.router.learn_threshold(self.routing_traces,
                                           target_recall=target_recall)


def _recover_wal_rebase(storage_dir: Path) -> None:
    """Finish a WAL rebase interrupted by a crash: ``wal.rebase`` is renamed
    into place only once fully written, so whichever directory survives is
    complete."""
    import shutil
    wal_dir = storage_dir / "wal"
    rebase = storage_dir / "wal.rebase"
    old = storage_dir / "wal.old"
    if not wal_dir.exists() and rebase.exists():
        rebase.rename(wal_dir)
    for leftover in (rebase, old):
        if leftover.exists():
            shutil.rmtree(leftover)
