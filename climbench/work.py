"""What a refine call must do, and the card's peaks to hold it against.

``kept_slots``, ``dedupe_segments``, ``refine_work`` and
``refine_topk_work`` are frozen copies of the program's
``repro_torch/kernels/refine_topk.py`` as it stood when the benchmark was
written, so a later change to the program cannot change the count: the
(query, record) pairs a refine must score and the distinct records whose
rows and norms it must read once a call.  The tags are charged apart from
the program's count: 8 bytes (DFS position and id) for each live record
(id >= 0) of each distinct partition the call plans, once a call.  No
design that reads the tags can read fewer, and the charge depends neither
on the store's padded width ``cap`` nor on how many queries plan a
partition.  Every count is taken on the reference's store, never the
program's.  ``tick_work`` applies them to a whole tick in blocks of
queries, each block cut to its widest live plan row (pads sort first and
count for nothing); its distinct records and tags are counted over the
whole tick.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Published peaks of the cards a run may report (NVIDIA's data sheets;
# dense, no sparsity), at the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "fp32_flops": 67e12},
}


class Work(NamedTuple):
    flops: float
    nbytes: float


def dedupe_segments(sel_part: torch.Tensor, incl: torch.Tensor) -> torch.Tensor:
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


def kept_slots(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi) -> torch.Tensor:
    pid = torch.clamp(sel_part, min=0).long()
    rdfs, rgid = rec_dfs[pid], rec_gid[pid]
    in_node = (rdfs >= sel_lo[:, :, None]) & (rdfs < sel_hi[:, :, None])
    incl = (rgid >= 0) & in_node & (sel_part >= 0)[:, :, None]
    return dedupe_segments(sel_part, incl)


def tag_records(rec_gid, sel_part) -> int:
    """Live records of the distinct partitions that ``sel_part`` plans:
    the tags a call must read, each once."""
    planned = torch.unique(sel_part[sel_part >= 0]).long()
    return int((rec_gid[planned] >= 0).sum())


def refine_work(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi) -> dict:
    kept = kept_slots(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi)
    cap = kept.shape[-1]
    slot = (torch.clamp(sel_part, min=0).long()[:, :, None] * cap
            + torch.arange(cap, device=kept.device))
    return {"kept_pairs": int(kept.sum()),
            "unique_kept_records": int(torch.unique(slot[kept]).numel()),
            "tag_records": tag_records(rec_gid, sel_part)}


def refine_topk_work(kept_pairs: int, unique_kept_records: int, tag_records: int,
                     nq: int, mp: int, n: int, k: int) -> Work:
    return Work(flops=kept_pairs * (2 * n + 3),
                nbytes=unique_kept_records * (4 * n + 4) + tag_records * 8
                + nq * n * 4 + 3 * nq * mp * 4 + nq * k * 8)


def tick_work(rec_dfs, rec_gid, sel_part, sel_lo, sel_hi, n: int, k: int,
              block: int = 16) -> Work:
    """One tick's refine work: its plan sorted by partition (pads first),
    counted in blocks of ``block`` queries; distinct records and the tags of
    the planned partitions over the whole tick; the plan read at the tick's
    widest live row."""
    order = torch.argsort(sel_part, dim=-1, stable=True)
    sp, lo, hi = (torch.gather(t, 1, order) for t in (sel_part, sel_lo, sel_hi))
    live = (sp >= 0).sum(dim=-1)
    cap = rec_gid.shape[1]
    pairs, uniq = 0, []
    for b0 in range(0, sp.shape[0], block):
        width = int(live[b0:b0 + block].max())
        if width == 0:
            continue
        cols = slice(sp.shape[1] - width, sp.shape[1])
        bsp, blo, bhi = sp[b0:b0 + block, cols], lo[b0:b0 + block, cols], hi[b0:b0 + block, cols]
        kept = kept_slots(rec_dfs, rec_gid, bsp, blo, bhi)
        pairs += int(kept.sum())
        slot = (torch.clamp(bsp, min=0).long()[:, :, None] * cap
                + torch.arange(cap, device=kept.device))
        uniq.append(torch.unique(slot[kept]))
    unique = int(torch.unique(torch.cat(uniq)).numel()) if uniq else 0
    return refine_topk_work(pairs, unique, tag_records(rec_gid, sp), sp.shape[0],
                            int(live.max()), n, k)


def bound_s(work: Work, kind: str) -> float:
    """The least time the card could take: bytes or fp32 operations."""
    peak = PEAKS[kind]
    return max(work.nbytes / peak["bytes_per_s"], work.flops / peak["fp32_flops"])
