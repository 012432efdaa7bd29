"""CLIMBER-kNN and CLIMBER-kNN-Adaptive planning in plain PyTorch (paper
§VI, Algorithm 3's ladder): the top-T candidate groups by (OD, WD), their
trie descents, and, for the adaptive planner, the memorised (node, parent)
entries expanded in quality order until they cover K, capped at
``adaptive_factor`` times the partitions CLIMBER-kNN would touch.
``spend`` scales K and the cap (rounded up), as the ``recall_target``
planner does.

A frozen copy of the host path of ``repro_torch.core.query.plan_knn`` and
``plan_adaptive`` as they stood when the benchmark was written: their
composite keys are built in float32 with fixed multipliers, and that
rounding is part of the plan's meaning, so the reference builds them the
same way.  The result is the
set of (partition, DFS interval) entries; their order and padding do not
change which records a query reads.
"""
from __future__ import annotations

import math

import torch

from climbench.reference.index import Index, descend, od_wd

_BIG = 1e9


def _take(t, idx):
    return torch.gather(t, -1, idx)


def _node_targets(trie, nodes):
    nl = nodes.long()
    parts = trie.part_ids_pad[nl]
    lo = trie.dfs_in[nl][..., None].expand_as(parts)
    hi = trie.dfs_out[nl][..., None].expand_as(parts)
    return parts, lo.to(torch.int32), hi.to(torch.int32)


def plan(index: Index, p4_rank_q: torch.Tensor, variant: str = "adaptive",
         spend: float = 1.0):
    """``(sel_part, sel_lo, sel_hi)`` ``[Q, E]``, pads ``-1``: the planner
    ``variant`` names, ``knn`` (Algorithm 3: the best node's partitions) or
    ``adaptive`` (spending ``spend`` times more: ``recall_target``)."""
    if variant not in ("knn", "adaptive"):
        raise ValueError(f"the reference has no planner {variant!r}")
    cfg = index.cfg
    k = cfg["k"]
    factor = cfg["adaptive_factor"]
    if spend != 1.0:
        k = int(math.ceil(k * spend))
        factor = int(math.ceil(factor * spend))
    trie = index.trie
    num_groups = index.centroid_onehot.shape[0]
    t = min(cfg["candidate_groups"], num_groups - 1) or 1

    od, wd = od_wd(p4_rank_q, index.centroid_onehot, cfg)
    score = od * (cfg["prefix_len"] + 2.0) + wd
    grp = torch.sort(score, dim=-1, stable=True).indices[:, :t]
    cand_od, cand_wd = _take(od, grp), _take(wd, grp)
    node, pathlen, parent = descend(trie, p4_rank_q[:, None, :].expand(-1, t, -1), grp)
    size = trie.node_size[node.long()]

    # Algorithm 3's winner: min OD, then min WD, then max (pathlen, size)
    min_od = cand_od.min(dim=-1, keepdim=True).values
    big = torch.full_like(cand_wd, _BIG)
    min_wd = torch.where(cand_od <= min_od + 0.5, cand_wd, big) \
        .min(dim=-1, keepdim=True).values
    eligible = (cand_od <= min_od + 0.5) & (cand_wd <= min_wd + 1e-6)
    key = torch.where(eligible, -(pathlen.to(torch.float32) * 1e6
                                  + torch.clamp(size, max=1e5)), big)
    best = torch.argmin(key, dim=-1)[:, None]
    q = grp.shape[0]
    node_star = _take(node, best)[:, 0]
    if variant == "knn":
        return _node_targets(trie, node_star)

    ent_node = torch.stack([node, parent], dim=-1).reshape(q, 2 * t)
    ent_od = torch.repeat_interleave(cand_od, 2, dim=-1)
    ent_wd = torch.repeat_interleave(cand_wd, 2, dim=-1)
    ent_path = torch.stack([pathlen, torch.clamp(pathlen - 1, min=0)],
                           dim=-1).reshape(q, 2 * t)
    ent_size = trie.node_size[ent_node.long()]
    order_key = (ent_od * (cfg["prefix_len"] + 2.0) + ent_wd) * 1e6 \
        - ent_path.to(torch.float32) * 1e3 - torch.clamp(ent_size, max=999.0)
    is_star = ent_node == node_star[:, None]
    order_key = torch.where(is_star, torch.full_like(order_key, -_BIG), order_key)
    order = torch.argsort(order_key, dim=-1, stable=True)
    ent_node = _take(ent_node, order)
    ent_size = _take(ent_size, order)
    dup = torch.cumsum((ent_node[:, :, None] == ent_node[:, None, :])
                       .to(torch.int32), dim=-1)
    first = torch.diagonal(dup, dim1=1, dim2=2) == 1
    ent_size = torch.where(first, ent_size, torch.zeros_like(ent_size))
    ent_od_sorted = _take(ent_od, order)
    od_tied = ent_od_sorted <= ent_od_sorted.min(dim=-1, keepdim=True).values + 0.5
    cum_before = torch.cumsum(ent_size, dim=-1) - ent_size
    selected = first & ((cum_before < float(k)) | od_tied)
    selected[:, 0] = True

    cap = (trie.part_ids_pad[node_star.long()] >= 0).sum(dim=-1) * factor
    parts, lo, hi = _node_targets(trie, ent_node)
    sel3 = selected[:, :, None] & (parts >= 0)
    flat_parts = torch.where(sel3, parts, -1).reshape(q, -1)
    live = flat_parts >= 0
    within = torch.cumsum(live.to(torch.int32), dim=-1) - 1
    flat_parts = torch.where(live & (within < cap[:, None]), flat_parts, -1)
    return flat_parts, lo.reshape(q, -1), hi.reshape(q, -1)
