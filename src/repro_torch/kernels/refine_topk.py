"""Streaming fused refine — masked squared ED + k-best in one pass: CUDA
kernel and plain version.

Replaces ``repro/kernels/refine_topk.py::refine_topk``.  Contract (the
reference's): the ``[Q, MP]`` plan is sorted by partition id along the entry
axis, pads (``-1``) first.  For each query and plan entry the candidates are
the ``cap`` slots of partition ``sel_part[q, s]`` at flat index
``s * cap + c``; a record is kept iff its gid ≥ 0, its DFS tag lies in
``[sel_lo, sel_hi)``, and no earlier entry of the same partition covers it.
Output: the ``k`` best ``(d², gid)`` by ``(d², flat index)``, ``3.4e38``/``-1``
where fewer than ``k`` candidates exist.

The kernel is ``csrc/refine_topk.cu``, in two designs that give the same
bits (see the source).  Partition-major, for plans whose partitions many
queries name: the plan is inverted on the card into (query, partition)
segments grouped by partition; a block reads each planned partition's tags
once, streams the rows some query of its item keeps into shared memory
once, and scores every such query from there, each dot summed in the
query-major design's order; each query's per-partition k best go to a few
lists of its own, cut early by a bound on its k-th key that every block
lowers, and a per-query kernel sorts the k best of its lists.  Query-major,
for the rest: blocks per query in proportion to its live slots stream its
kept rows, and a per-query merge of their sorted lists by merge path.  Both
are bound by HBM bytes: each distinct kept record's row and norm once, and
the tags.  The plain version gathers the ``[Q, MP, cap, n]`` candidate rows,
so it only fits small plans.

Every call records how much sharing its plan has, live (query, partition)
pairs over distinct planned partitions, in the histogram
``refine.queries_per_partition`` of ``repro_torch.obs.registry.REGISTRY``:
on the card either design counts it (the partition-major design in its
inversion, the query-major one in its merge), and it is read back into
pinned memory with no sync of its own and observed at a later call (or by
:func:`flush_sharing`); the plain version observes it from the plan.
"""
from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.obs.registry import REGISTRY

PAD_D2 = 3.4e38          # squared-distance sentinel of a pad answer
SHARING = "refine.queries_per_partition"
MAX_LISTS = 64           # lists a query's partitions' k-best go to, at most
MAX_SPLITS = 64          # blocks a query gets in the query-major design, at most
# plan entries a partition (Q * MP / P, pads included) from which a call
# takes the partition-major design.  On the cells' index the query-major
# design was faster up to 263 (1,024 adaptive / 512 spend 4 queries), the
# partition-major one from 395 (768 spend 4 queries) and at the ticks'
# 1,054-2,108; the smoke's and the kNN-LM's batches of 64 have 5-27
# (PERF.md §6)
PARTITION_MAJOR_MIN = 320


def dedupe_segments(sel_part: torch.Tensor, incl: torch.Tensor) -> torch.Tensor:
    """Drop records already included by an earlier same-partition entry.

    ``sel_part`` ``[Q, MP]`` must be sorted so equal ids are contiguous;
    ``incl`` is ``[Q, MP, cap]``.  Within a segment a slot is kept at the
    first entry whose interval covers it: the exclusive running inclusion
    count since the segment start is zero.
    """
    mp = sel_part.shape[-1]
    pos = torch.arange(mp, device=sel_part.device)
    seg_new = torch.cat([torch.ones_like(sel_part[:, :1], dtype=torch.bool),
                         sel_part[:, 1:] != sel_part[:, :-1]], dim=-1)
    seg_start = torch.cummax(torch.where(seg_new, pos[None, :], 0), dim=1).values
    inc = incl.to(torch.int32)
    ex_cum = torch.cumsum(inc, dim=1) - inc
    start_cum = torch.gather(
        ex_cum, 1, seg_start[:, :, None].expand(-1, -1, ex_cum.shape[-1]))
    return incl & ((ex_cum - start_cum) == 0)


def masked_distances(data, norms, rec_dfs, rec_gid, queries,
                     sel_part, sel_lo, sel_hi, dot_fn=None):
    """Dense ``[Q, MP·cap]`` masked squared ED (``PAD_D2`` where excluded)
    and gids (``-1``) over a partition-sorted plan.

    ``dot_fn(q [Q, n], rows [Q, MP, cap, n]) -> [Q, MP, cap]`` computes the
    dots; None is the plain expression (``ops.batched_query_dots`` runs the
    same through the ``qdots`` kernel on the card)."""
    q = queries.float()
    pid = torch.clamp(sel_part, min=0).long()                  # clamp pads
    rows = data[pid]                                           # [Q, MP, cap, n]
    # an elementwise product and a last-axis sum, not a batched matmul, so
    # each row's dot is summed in one order whatever the batch (a query's
    # answer does not depend on the batch it rides in)
    if dot_fn is None:
        dots = (rows * q[:, None, None, :]).sum(dim=-1)
    else:
        dots = dot_fn(q, rows)
    q2 = (q * q).sum(dim=-1)
    d2 = torch.clamp(q2[:, None, None] - 2.0 * dots + norms[pid], min=0.0)
    incl = kept_slots(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi)
    rgid = rec_gid[pid]
    qn = queries.shape[0]
    d2 = torch.where(incl, d2, torch.full_like(d2, PAD_D2)).reshape(qn, -1)
    gid = torch.where(incl, rgid, torch.full_like(rgid, -1)).reshape(qn, -1)
    return d2, gid


def kept_slots(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi) -> torch.Tensor:
    """``[Q, MP, cap]`` bool over a partition-sorted plan: the slots the
    fused refine keeps (gid ≥ 0, DFS tag in ``[sel_lo, sel_hi)``, entry not
    a pad, and not covered by an earlier entry of the same partition)."""
    pid = torch.clamp(sel_part, min=0).long()
    rdfs, rgid = rec_dfs[pid], rec_gid[pid]
    in_node = (rdfs >= sel_lo[:, :, None]) & (rdfs < sel_hi[:, :, None])
    incl = (rgid >= 0) & in_node & (sel_part >= 0)[:, :, None]
    return dedupe_segments(sel_part, incl)


def refine_work(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi) -> dict:
    """What the fused refine must do on a partition-sorted plan, counted
    from its tags alone: ``kept_pairs`` (query, record) distances,
    ``unique_kept_records`` distinct records behind them (the rows a
    kernel must read at least once), and ``live_slots`` (tags it tests)."""
    kept = kept_slots(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi)
    cap = kept.shape[-1]
    slot = (torch.clamp(sel_part, min=0).long()[:, :, None] * cap
            + torch.arange(cap, device=kept.device))
    return {"kept_pairs": int(kept.sum()),
            "unique_kept_records": int(torch.unique(slot[kept]).numel()),
            "live_slots": int((sel_part >= 0).sum()) * cap}


def refine_topk_work(kept_pairs: int, unique_kept_records: int, live_slots: int,
                     nq: int, mp: int, n: int, k: int) -> _lib.Work:
    """One call's work on a partition-sorted plan of ``nq`` queries and
    ``mp`` entries, from :func:`refine_work`'s counts: each distinct kept
    record's row and norm and each live slot's tags read once, the queries
    and the plan read, (d², gid) written; 2n + 3 operations a kept
    (query, record) pair."""
    return _lib.Work(flops=kept_pairs * (2 * n + 3),
                     nbytes=unique_kept_records * (4 * n + 4) + live_slots * 8
                     + nq * n * 4 + 3 * nq * mp * 4 + nq * k * 8)


def topk_flat(d2: torch.Tensor, gid: torch.Tensor, k: int):
    """The k smallest of ``[Q, C]`` by (d², column), padded past C.

    ``jax.lax.top_k`` breaks ties toward the lower index; a stable sort
    does the same, ``torch.topk`` promises no order.
    """
    if d2.shape[-1] < k:
        pad = k - d2.shape[-1]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=PAD_D2)
        gid = torch.nn.functional.pad(gid, (0, pad), value=-1)
    order = torch.sort(d2, dim=-1, stable=True).indices[:, :k]
    return torch.gather(d2, 1, order), torch.gather(gid, 1, order)


def refine_topk_plain(data, norms, rec_dfs, rec_gid, queries,
                      sel_part, sel_lo, sel_hi, k: int):
    """Plain PyTorch version of the fused refine (same contract)."""
    d2, gid = masked_distances(data, norms, rec_dfs, rec_gid, queries,
                               sel_part, sel_lo, sel_hi)
    return topk_flat(d2, gid, k)


def plan_sharing(sel_part: torch.Tensor):
    """``(pairs, partitions)`` of a partition-sorted plan: its live
    (query, partition) pairs (an entry naming a partition its query named
    already adds none) and its distinct planned partitions, the two counts
    either design of the kernel makes on the card."""
    live = sel_part >= 0
    new = live.clone()
    new[:, 1:] &= sel_part[:, 1:] != sel_part[:, :-1]
    return int(new.sum()), int(torch.unique(sel_part[live]).numel())


def observe_sharing(pairs: int, partitions: int) -> None:
    """One observation of ``refine.queries_per_partition``: pairs over
    partitions (0 for a plan of pads only)."""
    REGISTRY.histogram(SHARING).observe(pairs / partitions if partitions else 0.0)


class _SharingReadback:
    """The kernel's two counts of each call, copied into pinned memory
    behind the call on its stream and observed once the copy has landed,
    at a later call or at :func:`flush_sharing`: no call waits for its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = []

    def push(self, stats: torch.Tensor) -> None:
        host = torch.empty(2, dtype=torch.int64, pin_memory=True)
        host.copy_(stats, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(stats.device))
        with self._lock:
            self._pending.append((done, host))

    def drain(self, wait: bool = False) -> None:
        """Observe every landed count, in call order (``wait``: all)."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                done, host = self._pending[0]
                if not (wait or done.query()):
                    return
                self._pending.pop(0)
            done.synchronize()
            observe_sharing(int(host[0]), int(host[1]))


_SHARING = _SharingReadback()


def flush_sharing() -> None:
    """Observe every call's sharing count still in flight (waits for them)."""
    _SHARING.drain(wait=True)


@functools.lru_cache(maxsize=None)
def pick_splits(k: int) -> int:
    """The most blocks a query may get in the query-major design:
    ``MAX_SPLITS``, or fewer where its merge kernel's shared memory holds
    fewer lists of k.  The kernel gives each query a share of them in
    proportion to its live slots."""
    lib = _lib.library()
    s = MAX_SPLITS
    while s > 1 and lib.climber_refine_partial_merge_smem(s, k) > _lib.SMEM_LIMIT:
        s -= 1
    return s


def plan_lists(qn: int, mp: int, p: int, n: int, k: int, group: int) -> int:
    """Lists of k keys a query gets in the partition-major design: as many
    as the query-major design's scratch (its partial lists,
    :func:`pick_splits` a query) leaves room for beside the inverted plan;
    at least 8, and at most what the merge block holds."""
    lib = _lib.library()
    most = MAX_LISTS
    while most > 1 and lib.climber_refine_merge_smem(most, k) > _lib.SMEM_LIMIT:
        most -= 1
    budget = qn * (pick_splits(k) * k + 2) * 8
    fixed = lib.climber_refine_scratch_bytes(qn, mp, p, k, 0, group)
    fit = (budget - fixed) // (qn * (8 * k + 4))
    return max(min(8, most), min(most, fit))


def refine_topk(data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo,
                sel_hi, k: int, *, splits: Optional[int] = None):
    """Fused refine through the kernel for CUDA tensors, the plain version
    for CPU tensors, the kernel's outputs and counted work for ``meta``
    tensors.  A ``meta`` plan has no values to dedupe or mask: every entry
    counts as a live, whole partition of ``cap`` rows for its query (the
    reference dry-run's ``sel_rows`` rule), so ``kept_pairs``,
    ``unique_kept_records`` and ``live_slots`` are all ``Q · MP · cap``.

    On the card a call whose plan has at least ``PARTITION_MAJOR_MIN``
    entries a partition (``Q · MP / P``, known without a sync) takes the
    partition-major design, and any other the query-major one; both give
    the same answer bit for bit.

    Args:
      data / norms / rec_dfs / rec_gid: the store, ``[P, cap, n]`` f32 /
        ``[P, cap]`` f32, i32, i32.
      queries: ``[Q, n]`` f32.
      sel_part / sel_lo / sel_hi: ``[Q, MP]`` int32, sorted by partition.
      k: answers per query.
      splits: the most blocks a query may get in the query-major design,
        which a value here takes (None: :func:`pick_splits`); any value
        gives the same answer.

    Returns:
      (d2, gid): ``[Q, k]`` ascending squared ED (``PAD_D2`` past the
      candidate pool) and record ids (``-1`` there).
    """
    tensors = (data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo, sel_hi)
    if not _lib.on_card(*tensors):
        observe_sharing(*plan_sharing(sel_part))
        return refine_topk_plain(*tensors, k)
    qn, n = queries.shape
    mp = sel_part.shape[1]
    p, cap = norms.shape
    dev = queries.device
    if qn == 0 or mp == 0:
        return (torch.full((qn, k), PAD_D2, dtype=torch.float32, device=dev),
                torch.full((qn, k), -1, dtype=torch.int32, device=dev))
    _lib.require(data, "refine data", torch.float32, 3)
    _lib.require(norms, "refine norms", torch.float32, 2)
    _lib.require(rec_dfs, "refine rec_dfs", torch.int32, 2)
    _lib.require(rec_gid, "refine rec_gid", torch.int32, 2)
    _lib.require(queries, "refine queries", torch.float32, 2)
    for name, t in (("sel_part", sel_part), ("sel_lo", sel_lo), ("sel_hi", sel_hi)):
        _lib.require(t, f"refine {name}", torch.int32, 2)
        if t.shape != (qn, mp):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(qn, mp)}")
    if data.shape != (p, cap, n) or rec_dfs.shape != (p, cap) \
            or rec_gid.shape != (p, cap):
        raise ValueError("store columns disagree on [P, cap, n]")
    if mp * cap >= 2**31 or qn * mp >= 2**31 or k < 1:
        raise ValueError(f"refine kernel needs MP*cap < 2^31, Q*MP < 2^31 and "
                         f"k >= 1 (Q={qn}, MP={mp}, cap={cap}, k={k})")
    if dev.type == "meta":
        rows = qn * mp * cap
        return _lib.meta_outputs(refine_topk_work(rows, rows, rows, qn, mp, n, k),
                                 ((qn, k), torch.float32), ((qn, k), torch.int32))
    if splits is None and qn * mp >= PARTITION_MAJOR_MIN * p:
        return _partition_major(*tensors, k)
    return _query_major(*tensors, k, splits=splits)


def _launch(entry, tensors, k: int, scratch_bytes: int, *sizes):
    """One call of a design's C entry on validated, non-empty card tensors
    (``sizes``: its integer arguments): its scratch, the outputs, and the
    plan's two sharing counts, read back with no sync of their own."""
    queries = tensors[4]
    dev = queries.device
    d2 = torch.empty((queries.shape[0], k), dtype=torch.float32, device=dev)
    gid = torch.empty((queries.shape[0], k), dtype=torch.int32, device=dev)
    scratch = torch.empty((scratch_bytes + 7) // 8, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    _SHARING.drain()
    with torch.cuda.device(dev):
        _lib.check(entry(*(t.data_ptr() for t in tensors), scratch.data_ptr(),
                         stats.data_ptr(), d2.data_ptr(), gid.data_ptr(), *sizes,
                         _lib.stream(dev)), "refine_topk")
        _SHARING.push(stats)
    _lib.count_launch(refine_topk)
    return d2, gid


def _partition_major(data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo,
                     sel_hi, k: int, *, group: Optional[int] = None,
                     lists: Optional[int] = None):
    """The partition-major design on the card, with at most ``group``
    queries an item (None: as many as the block's shared memory holds) and
    ``lists`` lists a query (None: :func:`plan_lists`); any value gives the
    same answer.  Also counted in ``_partition_major.launches``."""
    (qn, n), mp, (p, cap) = queries.shape, sel_part.shape[1], norms.shape
    lib = _lib.library()
    most = lib.climber_refine_group(n, k)
    if most < 1:
        raise ValueError(f"refine kernel: n={n}, k={k} exceed the block's shared memory")
    g = min(most, group) if group else most
    nl = lists or plan_lists(qn, mp, p, n, k, g)
    if lib.climber_refine_merge_smem(nl, k) > _lib.SMEM_LIMIT:
        raise ValueError(f"refine kernel: {nl} lists x k={k} exceed the merge "
                         f"block's shared memory")
    out = _launch(lib.climber_refine_topk,
                  (data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo, sel_hi), k,
                  lib.climber_refine_scratch_bytes(qn, mp, p, k, nl, g),
                  qn, mp, p, cap, n, k, nl, g)
    _lib.count_launch(_partition_major)
    return out


def _query_major(data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo,
                 sel_hi, k: int, *, splits: Optional[int] = None):
    """The query-major design on the card, with at most ``splits`` blocks a
    query (None: :func:`pick_splits`); any value gives the same answer."""
    (qn, n), mp, (p, cap) = queries.shape, sel_part.shape[1], norms.shape
    lib = _lib.library()
    if lib.climber_refine_partial_smem(mp, n, k) > _lib.SMEM_LIMIT:
        raise ValueError(f"refine kernel: MP={mp}, n={n}, k={k} exceed the "
                         f"block's shared memory")
    s = splits or pick_splits(k)
    if lib.climber_refine_partial_merge_smem(s, k) > _lib.SMEM_LIMIT:
        raise ValueError(f"refine kernel: {s} splits x k={k} exceed the merge "
                         f"block's shared memory")
    return _launch(lib.climber_refine_topk_query_major,
                   (data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo, sel_hi), k,
                   lib.climber_refine_partial_scratch_bytes(qn, p, k, s),
                   qn, mp, p, cap, n, k, s)


refine_topk.launches = 0
_partition_major.launches = 0
