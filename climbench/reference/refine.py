"""Refine in plain PyTorch (paper §VI's last step): every record of the
planned (partition, DFS interval) entries, each once, ranked by its exact
squared distance to the query.

The distance is taken in float64 from the raw rows, so the reference's
ranking is the true one; the program works in float32, so its list may
differ from this one only among records whose distances lie within its
rounding of each other.  ``precision="tf32"`` is the control's refine: the
squared distance ``|q|² − 2 q·x + |x|²`` in float32 with ``q·x`` taken from
TF32-rounded inputs (see ``featurize.to_tf32``).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from climbench.reference.featurize import to_tf32
from climbench.reference.index import Store

PAD_DIST = float(torch.tensor(3.4e38, dtype=torch.float32).sqrt())


class Candidates(NamedTuple):
    """One query's candidate pool: store slots and their exact d²."""
    slot: torch.Tensor      # [C] int64 flat store slot (p * cap + c)
    gid: torch.Tensor       # [C] int64 collection row
    d2: torch.Tensor        # [C] float64


def kept_slots(store: Store, part, lo, hi) -> torch.Tensor:
    """Flat slots of one query's plan: records with gid >= 0 whose DFS tag
    lies in an entry's ``[lo, hi)``, each once, ascending."""
    live = part >= 0
    part, lo, hi = part[live].long(), lo[live], hi[live]
    if part.numel() == 0:
        return torch.zeros((0,), dtype=torch.int64, device=store.rec_gid.device)
    cap = store.rec_gid.shape[1]
    dfs, gid = store.rec_dfs[part], store.rec_gid[part]          # [E, cap]
    inside = (gid >= 0) & (dfs >= lo[:, None]) & (dfs < hi[:, None])
    slot = part[:, None] * cap + torch.arange(cap, device=part.device)
    return torch.unique(slot[inside])


def candidates(store: Store, data: torch.Tensor, query: torch.Tensor,
               part, lo, hi, precision: str = "fp32") -> Candidates:
    slot = kept_slots(store, part, lo, hi)
    gid = store.rec_gid.reshape(-1)[slot].long()
    x = data[gid]
    if precision == "tf32":
        q = query.float()
        dots = to_tf32(x) @ to_tf32(q)
        norms = store.norms.reshape(-1)[slot]
        d2 = torch.clamp((q * q).sum() - 2.0 * dots + norms, min=0.0).double()
    else:
        diff = x.double() - query.double()[None, :]
        d2 = (diff * diff).sum(dim=-1)
    return Candidates(slot, gid, d2)


def top_k(c: Candidates, k: int):
    """``(d2 [≤k] float64, gid [≤k] int64)`` of the k nearest candidates,
    ties to the lower slot."""
    order = torch.sort(c.d2, stable=True).indices[:k]
    return c.d2[order], c.gid[order]


def answers(store: Store, data: torch.Tensor, queries: torch.Tensor,
            sel_part, sel_lo, sel_hi, k: int, precision: str = "fp32"):
    """The control's answers in the program's form: ``(dist [Q, k] float32,
    gid [Q, k] int64)``, ``PAD_DIST`` / ``-1`` past the pool."""
    qn = queries.shape[0]
    dist = torch.full((qn, k), PAD_DIST, dtype=torch.float32)
    gids = torch.full((qn, k), -1, dtype=torch.int64)
    for i in range(qn):
        c = candidates(store, data, queries[i], sel_part[i], sel_lo[i],
                       sel_hi[i], precision)
        d2, g = top_k(c, k)
        dist[i, :d2.numel()] = d2.float().sqrt().cpu()
        gids[i, :g.numel()] = g.cpu()
    return dist, gids


def pools(store: Store, data: torch.Tensor, queries: torch.Tensor,
          sel_part, sel_lo, sel_hi) -> List[Candidates]:
    """Each query's candidate pool with exact d²."""
    return [candidates(store, data, queries[i], sel_part[i], sel_lo[i],
                       sel_hi[i]) for i in range(queries.shape[0])]
