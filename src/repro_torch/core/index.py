"""CLIMBER-INX — index construction workflow (paper §V, Fig. 6).

Four steps, staged as in the paper and the JAX package:
  1. sample → PAA → pivots (random, or farthest-point with
     ``pivot_method="maxmin"``) → rank-sensitive signatures;
  2. aggregate rank-insensitive signatures → group centroids (Algorithm 2);
  3. assign sample to groups → per-group tries → FFD leaf packing → skeleton;
  4. full-dataset pass: signatures → group (Algorithm 1) → trie routing →
     physical partitions.

Steps 1–3 run on the host in numpy over the sample, except the sample's PAA
and signatures, which come from the kernels (``kernels.ops``).  Step 4 runs
on the index's device in chunks, through the same kernels, and the store is
scattered there.

The physical store takes one of two layouts, by ``cfg.partition_pad``:

  * dense (``None`` or a positive pad): :class:`PartitionStore`, a
    ``[P, cap, n]`` array, every partition padded to ``cap`` slots (the
    fullest partition, or the pad) with ``rec_gid = -1`` past its records.
    The fleet inserts into its pad slots, and snapshots carry it as the JAX
    package's arrays;
  * ragged (``0``): :class:`RaggedStore`, each partition exactly its
    records: rows ``[R, n]`` in partition order, ``[R]`` norms, tags and
    ids, and per partition its first row ``start`` (int64) and ``count``.
    No pad slot is kept, so a collection whose partitions differ widely in
    size (SIFT-shaped data: the fullest about 11x the mean) holds its rows once.
    It serves through the same refine kernels as a dense store (which they
    see as its flat view) and gives the same answers bit for bit; the paths
    that write pad slots or carry the dense arrays refuse it
    (:func:`require_dense`).

Records carry their trie node's DFS tag, so record↔node attribution at
query time is an interval test.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import assignment
from repro_torch.core import centroids as centroids_mod
from repro_torch.core import pivots as pivots_mod
from repro_torch.core.signatures import set_signature
from repro_torch.core.traversal import TrieDevice, route_records
from repro_torch.core.trie import TrieForest, build_forest
from repro_torch.kernels import ops
from repro_torch.kernels.refine_topk import Ragged
from repro_torch.obs import REGISTRY, TRACER
from repro_torch.utils.config import ClimberConfig
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize

ROUTE_CHUNK = 1 << 18        # records per step-4 chunk


class PartitionStore(NamedTuple):
    """Physical partitions (the paper's HDFS blocks)."""

    data: torch.Tensor      # [P, cap, n] raw series (for exact ED refine)
    norms: torch.Tensor     # [P, cap]    precomputed |x|^2
    rec_dfs: torch.Tensor   # [P, cap]    dfs_in of the record's trie node
    rec_gid: torch.Tensor   # [P, cap]    original dataset row id (-1 = pad)
    count: torch.Tensor     # [P]         live records per partition

    @property
    def num_partitions(self) -> int:
        return self.data.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @property
    def ragged(self) -> None:
        """A dense store has no offsets: the kernels take its flat view."""
        return None


class RaggedStore(NamedTuple):
    """Physical partitions with no pad slot: partition ``p`` is rows
    ``start[p] .. start[p] + count[p]`` of every column."""

    data: torch.Tensor      # [R, n] raw series, in partition order
    norms: torch.Tensor     # [R]    precomputed |x|^2
    rec_dfs: torch.Tensor   # [R]    dfs_in of the record's trie node
    rec_gid: torch.Tensor   # [R]    original dataset row id
    start: torch.Tensor     # [P]    int64 first row of each partition
    count: torch.Tensor     # [P]    int32 records per partition
    cap: int                # the fullest partition's count

    @property
    def num_partitions(self) -> int:
        return self.start.shape[0]

    @property
    def capacity(self) -> int:
        return self.cap

    @property
    def ragged(self) -> Ragged:
        """Each partition's offsets as the refine kernels take them."""
        return Ragged(self.start, self.count, self.cap)


Store = Union[PartitionStore, RaggedStore]


def require_dense(store: Store, what: str) -> PartitionStore:
    """``store``, where it is dense; a :class:`RaggedStore` raises, so that
    no path that writes pad slots or carries ``[P, cap]`` arrays reads it."""
    if isinstance(store, RaggedStore):
        raise ValueError(f"{what} takes a dense [P, cap, n] PartitionStore; this "
                         f"store has the ragged layout (partition_pad=0)")
    return store


def store_bytes(store: Store) -> int:
    """Bytes of every tensor of the store (on the card, for an index there)."""
    return sum(t.numel() * t.element_size() for t in store
               if isinstance(t, torch.Tensor))


def live_bytes(store: Store) -> int:
    """Bytes the live records need: each its row, norm, tag and id."""
    n = store.data.shape[-1]
    return int(store.count.sum()) * (4 * n + 12)


@dataclass
class ClimberIndex:
    """The complete index: skeleton + store, all on one device."""

    cfg: ClimberConfig
    pivots: torch.Tensor            # [r, w]
    centroid_onehot: torch.Tensor   # [G, r], row 0 = fall-back
    forest: TrieForest              # host skeleton (numpy)
    trie: TrieDevice                # device skeleton
    store: Store
    build_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def num_groups(self) -> int:
        return self.centroid_onehot.shape[0]

    @property
    def device(self) -> torch.device:
        return self.store.data.device

    def featurize(self, series: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw ``[B, n]`` → (p4_rank ``[B, m]``, paa ``[B, w]``), through the
        PAA and pivot-rank kernels on the card."""
        z = ops.paa(series, self.cfg.paa_segments)
        p4r = ops.pivot_rank(z, self.pivots, self.cfg.prefix_len)
        return p4r, z


def _route_full_dataset(data: torch.Tensor, pivots: torch.Tensor,
                        centroid_onehot: torch.Tensor, trie: TrieDevice,
                        cfg: ClimberConfig, chunk: int = ROUTE_CHUNK):
    """Step 4: signatures → groups → partitions for every record, in chunks
    of ``chunk`` records.  Returns (part, rec_dfs) ``[N]`` int32 each."""
    parts, dfs = [], []
    for lo in range(0, data.shape[0], chunk):
        z = ops.paa(data[lo:lo + chunk], cfg.paa_segments)
        p4r = ops.pivot_rank(z, pivots, cfg.prefix_len)
        grp = assignment.assign_groups(
            p4r, centroid_onehot, cfg.num_pivots,
            decay=cfg.decay, decay_lambda=cfg.decay_lambda)
        part, rec_dfs = route_records(trie, p4r, grp)
        parts.append(part)
        dfs.append(rec_dfs)
    return torch.cat(parts), torch.cat(dfs)


def build_store(data: torch.Tensor, part: torch.Tensor, rec_dfs: torch.Tensor,
                num_partitions: int, pad: Optional[int] = None,
                chunk: int = ROUTE_CHUNK) -> Store:
    """Place the records in their partitions, on the data's device.  Record
    order: stable sort by partition, so slot c of a partition holds its c-th
    record in dataset order; norms are summed in float64 and cast to
    float32.  ``pad`` 0 builds a :class:`RaggedStore`; None or a positive
    pad a dense :class:`PartitionStore` of ``max(pad, fullest)`` slots a
    partition.  Either is written in chunks of ``chunk`` records."""
    dev = data.device
    n_rec, series_len = data.shape
    part = part.to(dev).long()
    rec_dfs = rec_dfs.to(dev)
    counts = torch.bincount(part, minlength=num_partitions)
    fullest = int(counts.max())
    order = torch.argsort(part, stable=True)
    starts = torch.cumsum(counts, dim=0) - counts
    if pad == 0:
        rows = torch.empty((n_rec, series_len), dtype=torch.float32, device=dev)
        norms = torch.empty((n_rec,), dtype=torch.float32, device=dev)
        for lo in range(0, n_rec, chunk):
            x = data[order[lo:lo + chunk]].float()
            rows[lo:lo + chunk] = x
            norms[lo:lo + chunk] = (x.double() ** 2).sum(dim=-1).float()
        return RaggedStore(data=rows, norms=norms,
                           rec_dfs=rec_dfs[order].to(torch.int32),
                           rec_gid=order.to(torch.int32), start=starts,
                           count=counts.to(torch.int32), cap=max(fullest, 1))
    cap = max(fullest if pad is None else max(pad, fullest), 1)
    part_sorted = part[order]
    slot = torch.arange(n_rec, device=dev) - starts[part_sorted]

    store_data = torch.zeros((num_partitions, cap, series_len),
                             dtype=torch.float32, device=dev)
    norms = torch.zeros((num_partitions, cap), dtype=torch.float32, device=dev)
    for lo in range(0, n_rec, chunk):
        rows = order[lo:lo + chunk]
        p, s = part_sorted[lo:lo + chunk], slot[lo:lo + chunk]
        x = data[rows].float()
        store_data[p, s] = x
        norms[p, s] = (x.double() ** 2).sum(dim=-1).float()
    store_dfs = torch.full((num_partitions, cap), -1, dtype=torch.int32, device=dev)
    store_gid = torch.full((num_partitions, cap), -1, dtype=torch.int32, device=dev)
    store_dfs[part_sorted, slot] = rec_dfs[order].to(torch.int32)
    store_gid[part_sorted, slot] = order.to(torch.int32)
    return PartitionStore(data=store_data, norms=norms, rec_dfs=store_dfs,
                          rec_gid=store_gid, count=counts.to(torch.int32))


def sample_size(n_rec: int, cfg: ClimberConfig) -> int:
    """Records in the step-1 sample (the reference's clip rule)."""
    return int(np.clip(int(n_rec * cfg.sample_frac),
                       min(n_rec, max(4 * cfg.num_pivots, 256)), n_rec))


def build_index(data: torch.Tensor, cfg: ClimberConfig, *,
                device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                sample_idx=None, pivot_idx=None,
                pivot_method: str = "random") -> ClimberIndex:
    """End-to-end CLIMBER-INX construction (Fig. 6) on ``device``.

    ``sample_idx`` (``[S]``, S = :func:`sample_size`) and ``pivot_idx``
    are the build's two random draws; when omitted they come from
    ``generator``.  ``pivot_method="random"`` takes ``pivot_idx`` as the
    ``[r]`` pivot rows of the sample; ``"maxmin"`` (farthest-point, the
    reference's beyond-paper option) as the single row it starts from.
    Handing over the JAX package's draws reproduces its forest, centroids
    and store exactly.  Each step runs in a ``build.<step>`` span (sample,
    centroids, skeleton, route, store); ``index.build_seconds`` holds the
    spans' durations and their sum as ``total``.
    """
    dev = resolve_device(device)
    n_rec, series_len = data.shape
    if series_len != cfg.series_len:
        raise ValueError(f"data series_len {series_len} != cfg {cfg.series_len}")
    data = data.to(dev, torch.float32)
    spans = {}

    # ---- Step 1: sample, PAA, pivots, signatures ------------------------
    with TRACER.span("build.sample") as spans["sample"]:
        s = sample_size(n_rec, cfg)
        alpha_eff = s / n_rec
        if sample_idx is None:
            sample_idx = pivots_mod.draw_indices(n_rec, s, generator, dev)
        sample_idx = pivots_mod.as_index(sample_idx, dev)
        if sample_idx.shape != (s,):
            raise ValueError(f"sample_idx has shape "
                             f"{tuple(sample_idx.shape)}, expected ({s},)")
        sample_paa = ops.paa(data[sample_idx], cfg.paa_segments)
        pivots = pivots_mod.select_pivots(sample_paa, cfg.num_pivots,
                                          idx=pivot_idx, generator=generator,
                                          method=pivot_method)
        p4r_s = ops.pivot_rank(sample_paa, pivots, cfg.prefix_len)
        p4r_np = p4r_s.cpu().numpy()
        p4s_np = set_signature(p4r_s).cpu().numpy()

    # ---- Step 2: centroids (host, Algorithm 2) --------------------------
    with TRACER.span("build.centroids") as spans["centroids"]:
        cents = centroids_mod.compute_centroids(
            p4s_np, cfg.num_pivots, sample_frac=alpha_eff,
            capacity=cfg.capacity, min_od=cfg.centroid_min_od,
            max_centroids=cfg.max_centroids)
        c_onehot = torch.as_tensor(cents.onehot, device=dev)

    # ---- Step 3: sample groups → tries → packing (host) -----------------
    with TRACER.span("build.skeleton") as spans["skeleton"]:
        uniq, counts = np.unique(p4r_np, axis=0, return_counts=True)
        grp_s = assignment.assign_groups(
            torch.as_tensor(uniq, device=dev), c_onehot, cfg.num_pivots,
            decay=cfg.decay, decay_lambda=cfg.decay_lambda)
        forest = build_forest(uniq, counts, grp_s.cpu().numpy(),
                              cents.num_groups, cfg.num_pivots,
                              capacity=float(cfg.capacity),
                              sample_frac=alpha_eff)
        trie_dev = TrieDevice.from_forest(forest, dev)

    # ---- Step 4: full-dataset routing + physical store -------------------
    with TRACER.span("build.route") as spans["route"]:
        part, rec_dfs = _route_full_dataset(data, pivots, c_onehot, trie_dev,
                                            cfg)
        synchronize(dev)
    with TRACER.span("build.store") as spans["store"]:
        store = build_store(data, part, rec_dfs, forest.num_partitions,
                            pad=cfg.partition_pad)
        synchronize(dev)
    REGISTRY.gauge("index.store_bytes").set(store_bytes(store))
    REGISTRY.gauge("index.store_live_bytes").set(live_bytes(store))
    secs = {step: sp.duration_ms * 1e-3 for step, sp in spans.items()}
    secs["total"] = sum(secs.values())
    return ClimberIndex(cfg=cfg, pivots=pivots, centroid_onehot=c_onehot,
                        forest=forest, trie=trie_dev, store=store,
                        build_seconds=secs)


# the forest tables a JAX-package snapshot carries (fleet/lifecycle/snapshot.py)
FOREST_ARRAYS = ("child_start", "edge_pivot", "edge_child", "edge_key",
                 "node_size", "node_depth", "dfs_in", "dfs_out",
                 "part_start", "part_ids", "group_root", "group_default_part")


def index_from_arrays(arrays: Mapping[str, np.ndarray], cfg: ClimberConfig,
                      device: DeviceLike = None) -> ClimberIndex:
    """Carry a JAX-package index across as the port's :class:`ClimberIndex`.

    ``arrays`` is laid out as ``repro.fleet.lifecycle.snapshot.save_shard``
    writes it: ``store_<field>`` for every :class:`PartitionStore` field,
    ``forest_<name>`` for each name in :data:`FOREST_ARRAYS`, ``pivots`` and
    ``centroid_onehot``.  The forest's scalars are re-derived (partition
    count from the store, parts-per-node bound from ``part_start``) and the
    device trie is rebuilt from the forest, as ``load_shard`` does.
    """
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    store = store_from_arrays(arrays, dev)
    pivots = t(arrays["pivots"]).float()
    if pivots.shape != (cfg.num_pivots, cfg.paa_segments):
        raise ValueError(f"pivots have shape {tuple(pivots.shape)}, cfg wants "
                         f"{(cfg.num_pivots, cfg.paa_segments)}")
    forest = forest_from_arrays(arrays, store.num_partitions, cfg.num_pivots)
    return ClimberIndex(cfg=cfg, pivots=pivots,
                        centroid_onehot=t(arrays["centroid_onehot"]).float(),
                        forest=forest, trie=TrieDevice.from_forest(forest, dev),
                        store=store)


def store_from_arrays(arrays: Mapping[str, np.ndarray],
                      device: torch.device) -> PartitionStore:
    """The store from its ``store_<field>`` arrays, on ``device``."""
    return PartitionStore(*[torch.from_numpy(np.array(arrays["store_" + name])).to(device)
                            for name in PartitionStore._fields])


def forest_from_arrays(arrays: Mapping[str, np.ndarray], num_partitions: int,
                       num_pivots: int) -> TrieForest:
    """The host forest from its ``forest_<name>`` tables; the parts-per-node
    bound is re-derived from ``part_start``."""
    tables = {name: np.asarray(arrays["forest_" + name]) for name in FOREST_ARRAYS}
    per_node = np.diff(tables["part_start"])
    return TrieForest(**tables, num_partitions=num_partitions,
                      num_pivots=num_pivots,
                      max_parts_per_node=int(per_node.max()) if per_node.size else 1)
