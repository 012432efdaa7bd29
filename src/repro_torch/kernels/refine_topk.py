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

The kernel is ``csrc/refine_topk.cu``: a plan kernel that gives each query
blocks in proportion to its live slots, partial k-best blocks that scan tags
first and then stream the kept rows with many loads in flight, and a
per-query merge of the sorted partial lists by merge path, all by the same
exact key (see the source for the design).  It is bound by HBM bytes: each
distinct kept record's row and norm once, and 8 bytes of tags per live slot.
The plain version gathers the ``[Q, MP, cap, n]`` candidate rows, so it only
fits small plans.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _lib

PAD_D2 = 3.4e38          # squared-distance sentinel of a pad answer
MAX_SPLITS = 64


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


@functools.lru_cache(maxsize=None)
def pick_splits(k: int) -> int:
    """The most blocks a query may get: ``MAX_SPLITS``, or fewer where the
    merge kernel's shared memory holds fewer lists of k.  The kernel gives
    each query a share of them in proportion to its live slots."""
    lib = _lib.library()
    s = MAX_SPLITS
    while s > 1 and lib.climber_refine_merge_smem(s, k) > _lib.SMEM_LIMIT:
        s -= 1
    return s


def refine_topk(data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo,
                sel_hi, k: int, *, splits: Optional[int] = None):
    """Fused refine through the kernel for CUDA tensors, the plain version
    for CPU tensors, the kernel's outputs and counted work for ``meta``
    tensors.  A ``meta`` plan has no values to dedupe or mask: every entry
    counts as a live, whole partition of ``cap`` rows for its query (the
    reference dry-run's ``sel_rows`` rule), so ``kept_pairs``,
    ``unique_kept_records`` and ``live_slots`` are all ``Q · MP · cap``.

    Args:
      data / norms / rec_dfs / rec_gid: the store, ``[P, cap, n]`` f32 /
        ``[P, cap]`` f32, i32, i32.
      queries: ``[Q, n]`` f32.
      sel_part / sel_lo / sel_hi: ``[Q, MP]`` int32, sorted by partition.
      k: answers per query.
      splits: the most blocks a query may get (None: :func:`pick_splits`);
        any value gives the same answer.

    Returns:
      (d2, gid): ``[Q, k]`` ascending squared ED (``PAD_D2`` past the
      candidate pool) and record ids (``-1`` there).
    """
    tensors = (data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo, sel_hi)
    if not _lib.on_card(*tensors):
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
    if mp * cap >= 2**31 or k < 1:
        raise ValueError(f"refine kernel needs MP*cap < 2^31 and k >= 1 "
                         f"(MP={mp}, cap={cap}, k={k})")
    if dev.type == "meta":
        rows = qn * mp * cap
        return _lib.meta_outputs(refine_topk_work(rows, rows, rows, qn, mp, n, k),
                                 ((qn, k), torch.float32), ((qn, k), torch.int32))
    lib = _lib.library()
    if lib.climber_refine_partial_smem(mp, n, k) > _lib.SMEM_LIMIT:
        raise ValueError(f"refine kernel: MP={mp}, n={n}, k={k} exceed the "
                         f"block's shared memory")
    s = splits or pick_splits(k)
    if lib.climber_refine_merge_smem(s, k) > _lib.SMEM_LIMIT:
        raise ValueError(f"refine kernel: {s} splits x k={k} exceed the merge "
                         f"block's shared memory")
    # the partial lists [Q, splits, k], then a plan summary and a work
    # counter per query
    partial = torch.empty(qn * (s * k + 2), dtype=torch.int64, device=dev)
    d2 = torch.empty((qn, k), dtype=torch.float32, device=dev)
    gid = torch.empty((qn, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _lib.check(lib.climber_refine_topk(
            data.data_ptr(), norms.data_ptr(), rec_dfs.data_ptr(),
            rec_gid.data_ptr(), queries.data_ptr(), sel_part.data_ptr(),
            sel_lo.data_ptr(), sel_hi.data_ptr(), partial.data_ptr(),
            d2.data_ptr(), gid.data_ptr(), qn, mp, cap, n, k, s,
            _lib.stream(dev)), "refine_topk")
    _lib.count_launch(refine_topk)
    return d2, gid


refine_topk.launches = 0
