"""CLIMBER query processing — paper §VI (Algorithm 3 + the Adaptive variant).

Planners emit static-width selections ``[Q, slots]`` of (partition, DFS
interval) targets:

  * ``plan_knn``       — CLIMBER-kNN (Algorithm 3): one best trie node and
    the partitions associated with it;
  * ``plan_adaptive``  — CLIMBER-kNN-Adaptive: memorises the top-T candidate
    groups and, per group, the landing node and its parent, and expands down
    that ranking until the cumulative size covers K, capped at
    ``adaptive_factor`` × the partitions CLIMBER-kNN would touch;
  * ``plan_od_smallest`` — the §VII-C ablation: every partition of every
    group at the minimal OD;
  * ``plan_exhaustive`` — every partition (exact kNN).

All ladders follow Algorithm 3's tie-breaks: OD → WD → PathLen (desc) →
node size (desc) → lowest id.  The composite keys are built in fp32 with the
JAX package's multipliers and operation order, because their rounding is
part of the semantics.  ``jax.lax.top_k`` and ``jnp.argsort`` are replaced
by stable sorts, which keep the lowest-index tie-break.

:func:`plan` runs a registered planner and compacts the plan to a static
slot budget (:func:`compact_plan`, :func:`default_slot_budget`);
:func:`knn_query` composes featurize → plan → refine.
:func:`make_recall_target_planner` / :func:`register_recall_target` add an
adaptive variant that spends more.

Every planner also runs against a *padded* shard skeleton: the fleet's
stacked pass (``repro_torch.fleet.placement``) plans each sealed shard from
``[S, ...]`` trie tables padded to fleet-wide maxima, so the planner gets a
:class:`ShardPlanContext` with the shard's real group, candidate and
partition counts next to the padded widths; columns past the real counts
are masked to the ``_BIG`` sentinel before any sort or arg-reduction, which
keeps the live plan entries (values and order) equal to the host
planner's.  ``ctx=None`` is the host path, unchanged.  Planners that run
on that path are registered in a second registry
(:func:`register_device_planner`); the four built-ins are.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import assignment
from repro_torch.core.index import ClimberIndex, PartitionStore
from repro_torch.core.refine import dispatch_refine
from repro_torch.core.traversal import descend

_BIG = 1e9
_INT32_MAX = 2**31 - 1


class ShardPlanContext(NamedTuple):
    """Real-vs-padded shape context for planning over a padded skeleton.

    The counts may be Python ints (the fleet's stacked pass knows them on
    the host, so planning needs no copy back from the card) or 0-dim
    tensors.  ``None`` ctx (the host path) means real == padded.
    """

    num_groups: int         # real centroid rows (incl. the fallback row 0)
    num_candidates: int     # real T for this shard
    num_partitions: int     # real partition count
    t_static: int           # padded candidate width
    p_static: int           # padded partition width (exhaustive plans)


class QueryPlan(NamedTuple):
    """Static-width partition/node targets for a batch of queries."""

    sel_part: torch.Tensor   # [Q, MP] partition ids, -1 padded
    sel_lo: torch.Tensor     # [Q, MP] dfs interval lo of targeting node
    sel_hi: torch.Tensor     # [Q, MP] dfs interval hi
    node: torch.Tensor       # [Q] the Algorithm-3 landing node (best group)
    pathlen: torch.Tensor    # [Q]

    def partitions_touched(self) -> torch.Tensor:
        """#distinct partitions accessed per query."""
        sp = torch.sort(self.sel_part, dim=-1).values
        return _first_occurrence_mask(sp).sum(dim=-1)


def _first_occurrence_mask(sp_sorted: torch.Tensor) -> torch.Tensor:
    """First occurrence of each distinct non-pad id along the sorted axis."""
    return torch.cat([sp_sorted[:, :1] >= 0,
                      (sp_sorted[:, 1:] != sp_sorted[:, :-1])
                      & (sp_sorted[:, 1:] >= 0)], dim=-1)


def _num_candidates(index: ClimberIndex) -> int:
    """T — candidate groups actually retained (bounded by #groups)."""
    return min(index.cfg.candidate_groups, index.num_groups - 1) or 1


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, -1, idx)


def candidates_scanned(plan: QueryPlan, store: PartitionStore) -> torch.Tensor:
    """#records resident in the distinct partitions a query reads."""
    sp = torch.sort(plan.sel_part, dim=-1).values
    cnt = store.count[torch.clamp(sp, min=0).long()]
    return torch.where(_first_occurrence_mask(sp), cnt, 0).sum(dim=-1)


def _candidates(index: ClimberIndex, p4_rank_q: torch.Tensor,
                ctx: Optional[ShardPlanContext] = None):
    """Top-T candidate groups by the (OD, WD) ladder + their trie descent.

    With ``ctx`` the centroid columns past the shard's real group count are
    masked to ``_BIG`` before the sort, and candidate slots past the real T
    after it; the stable sort's lowest-index tie-break then makes the first
    ``ctx.num_candidates`` picks the host planner's.
    """
    cfg = index.cfg
    t = ctx.t_static if ctx is not None else _num_candidates(index)
    od, wd = assignment.assignment_distances(
        p4_rank_q, index.centroid_onehot, cfg.num_pivots,
        decay=cfg.decay, decay_lambda=cfg.decay_lambda)
    if ctx is not None:
        pad_col = torch.arange(od.shape[-1], device=od.device) >= ctx.num_groups
        od = torch.where(pad_col[None, :], _BIG, od)
        wd = torch.where(pad_col[None, :], _BIG, wd)
    # lexicographic (od, wd): od is integral in [0, m]; wd bounded by TW < m+1
    score = od * (cfg.prefix_len + 2.0) + wd
    grp = torch.sort(score, dim=-1, stable=True).indices[:, :t]    # [Q, T]
    cand_od, cand_wd = _take(od, grp), _take(wd, grp)
    node, pathlen, parent = descend(
        index.trie, p4_rank_q[:, None, :].expand(-1, t, -1), grp)
    size = index.trie.node_size[node.long()]
    if ctx is not None:
        valid = (torch.arange(t, device=od.device) < ctx.num_candidates)[None, :]
        cand_od = torch.where(valid, cand_od, _BIG)
        cand_wd = torch.where(valid, cand_wd, _BIG)
        size = torch.where(valid, size, 0.0)
    return grp, cand_od, cand_wd, node, pathlen, parent, size


def _rank_best(cand_od, cand_wd, pathlen, size):
    """Algorithm 3 lines 5–19 as one composite key; returns argbest [Q]."""
    min_od = cand_od.min(dim=-1, keepdim=True).values
    big = torch.full_like(cand_wd, _BIG)
    min_wd = torch.where(cand_od <= min_od + 0.5, cand_wd, big) \
        .min(dim=-1, keepdim=True).values
    eligible = (cand_od <= min_od + 0.5) & (cand_wd <= min_wd + 1e-6)
    # among eligible: maximize (pathlen, size) → minimize negatives
    key = torch.where(eligible,
                      -(pathlen.to(torch.float32) * 1e6
                        + torch.clamp(size, max=1e5)),
                      big)
    return torch.argmin(key, dim=-1)                             # [Q]


def _node_targets(index: ClimberIndex, nodes: torch.Tensor):
    """Partitions + dfs intervals of a batch of nodes.  [..., maxP]."""
    nl = nodes.long()
    parts = index.trie.part_ids_pad[nl]                          # [..., maxP]
    lo = index.trie.dfs_in[nl][..., None].expand_as(parts)
    hi = index.trie.dfs_out[nl][..., None].expand_as(parts)
    return parts, lo.to(torch.int32), hi.to(torch.int32)


def plan_knn(index: ClimberIndex, p4_rank_q: torch.Tensor,
             ctx: Optional[ShardPlanContext] = None) -> QueryPlan:
    """CLIMBER-kNN (Algorithm 3)."""
    grp, od, wd, node, pathlen, parent, size = _candidates(index, p4_rank_q, ctx)
    best = _rank_best(od, wd, pathlen, size)[:, None]           # [Q, 1]
    node_star = _take(node, best)[:, 0]
    parts, lo, hi = _node_targets(index, node_star)
    return QueryPlan(sel_part=parts, sel_lo=lo, sel_hi=hi,
                     node=node_star, pathlen=_take(pathlen, best)[:, 0])


def plan_adaptive(index: ClimberIndex, p4_rank_q: torch.Tensor,
                  ctx: Optional[ShardPlanContext] = None) -> QueryPlan:
    """CLIMBER-kNN-Adaptive (paper §VI)."""
    cfg = index.cfg
    grp, od, wd, node, pathlen, parent, size = _candidates(index, p4_rank_q, ctx)
    best = _rank_best(od, wd, pathlen, size)[:, None]
    q, t = grp.shape
    node_star = _take(node, best)[:, 0]
    pathlen_star = _take(pathlen, best)[:, 0]

    # memorised entries: per group the landing node then its parent
    ent_node = torch.stack([node, parent], dim=-1).reshape(q, 2 * t)
    ent_od = torch.repeat_interleave(od, 2, dim=-1)
    ent_wd = torch.repeat_interleave(wd, 2, dim=-1)
    ent_path = torch.stack([pathlen, torch.clamp(pathlen - 1, min=0)],
                           dim=-1).reshape(q, 2 * t)
    ent_size = index.trie.node_size[ent_node.long()]

    # quality order (od, wd, -pathlen, -size); the Algorithm-3 winner first
    order_key = (ent_od * (cfg.prefix_len + 2.0) + ent_wd) * 1e6 \
        - ent_path.to(torch.float32) * 1e3 \
        - torch.clamp(ent_size, max=999.0)
    is_star = ent_node == node_star[:, None]
    order_key = torch.where(is_star, torch.full_like(order_key, -_BIG), order_key)
    order = torch.argsort(order_key, dim=-1, stable=True)
    ent_node = _take(ent_node, order)
    ent_size = _take(ent_size, order)

    # drop duplicate nodes (parent == node at roots, or one node reached
    # from several ladders): keep each node's first occurrence
    dup = torch.cumsum((ent_node[:, :, None] == ent_node[:, None, :])
                       .to(torch.int32), dim=-1)
    first_occurrence = torch.diagonal(dup, dim1=1, dim2=2) == 1
    ent_size = torch.where(first_occurrence, ent_size, torch.zeros_like(ent_size))
    if ctx is not None:
        # padded candidate slots can land on the real fallback group 0 (the
        # sort fills the tail with _BIG-tied columns, lowest index first);
        # the host planner never memorises them, so they must not expand or
        # count toward coverage
        ent_valid = torch.repeat_interleave(
            torch.arange(t, device=grp.device) < ctx.num_candidates, 2)
        ent_valid = _take(ent_valid[None, :].expand(q, -1), order)
        ent_size = torch.where(ent_valid, ent_size, torch.zeros_like(ent_size))

    # expansion rule (§VI): all groups tied at the smallest OD, and entries
    # until the cumulative size covers K
    ent_od_sorted = _take(ent_od, order)
    min_od = ent_od_sorted.min(dim=-1, keepdim=True).values
    od_tied = ent_od_sorted <= min_od + 0.5
    cum_before = torch.cumsum(ent_size, dim=-1) - ent_size
    need = cum_before < float(cfg.k)
    selected = first_occurrence & (need | od_tied)
    if ctx is not None:
        selected = selected & ent_valid
    selected[:, 0] = True

    # partition cap: adaptive_factor × the partitions CLIMBER-kNN touches
    star_parts = index.trie.part_ids_pad[node_star.long()]      # [Q, maxP]
    cap = (star_parts >= 0).sum(dim=-1) * cfg.adaptive_factor   # [Q]

    parts, lo, hi = _node_targets(index, ent_node)              # [Q, 2T, maxP]
    sel3 = selected[:, :, None] & (parts >= 0)
    flat_parts = torch.where(sel3, parts, -1).reshape(q, -1)
    flat_lo = lo.reshape(q, -1)
    flat_hi = hi.reshape(q, -1)
    # enforce the cap in entry order (first-node partitions always survive)
    live = flat_parts >= 0
    idx_within = torch.cumsum(live.to(torch.int32), dim=-1) - 1
    keep = live & (idx_within < cap[:, None])
    flat_parts = torch.where(keep, flat_parts, -1)
    return QueryPlan(sel_part=flat_parts, sel_lo=flat_lo, sel_hi=flat_hi,
                     node=node_star, pathlen=pathlen_star)


def exhaustive_selection(num_partitions: int, q: int, device):
    """(sel_part, sel_lo, sel_hi) selecting every record of every partition
    (full partition range, DFS interval [0, int32 max))."""
    parts = torch.arange(num_partitions, dtype=torch.int32,
                         device=device)[None, :].expand(q, -1)
    lo = torch.zeros((q, num_partitions), dtype=torch.int32, device=device)
    hi = torch.full((q, num_partitions), _INT32_MAX, dtype=torch.int32,
                    device=device)
    return parts, lo, hi


def plan_exhaustive(index: ClimberIndex, p4_rank_q: torch.Tensor,
                    ctx: Optional[ShardPlanContext] = None) -> QueryPlan:
    """Lossless fallback: scan every partition (exact kNN over the store)."""
    q = p4_rank_q.shape[0]
    if ctx is not None:
        parts, lo, hi = exhaustive_selection(ctx.p_static, q, p4_rank_q.device)
        parts = torch.where(parts < ctx.num_partitions, parts, -1)
    else:
        parts, lo, hi = exhaustive_selection(index.store.num_partitions, q,
                                             p4_rank_q.device)
    zero = torch.zeros((q,), dtype=torch.int32, device=p4_rank_q.device)
    return QueryPlan(sel_part=parts, sel_lo=lo, sel_hi=hi, node=zero, pathlen=zero)


def plan_od_smallest(index: ClimberIndex, p4_rank_q: torch.Tensor,
                     ctx: Optional[ShardPlanContext] = None) -> QueryPlan:
    """OD-Smallest ablation (§VII-C): all partitions of all min-OD groups."""
    grp, od, wd, node, pathlen, parent, size = _candidates(index, p4_rank_q, ctx)
    min_od = od.min(dim=-1, keepdim=True).values
    sel_grp = od <= min_od + 0.5                                # [Q, T]
    roots = index.trie.group_root[grp]                          # [Q, T]
    parts, lo, hi = _node_targets(index, roots)                 # [Q, T, maxP]
    q = grp.shape[0]
    sel3 = sel_grp[:, :, None] & (parts >= 0)
    flat_parts = torch.where(sel3, parts, -1).reshape(q, -1)
    best = _rank_best(od, wd, pathlen, size)[:, None]
    return QueryPlan(sel_part=flat_parts,
                     sel_lo=lo.reshape(q, -1), sel_hi=hi.reshape(q, -1),
                     node=_take(node, best)[:, 0],
                     pathlen=_take(pathlen, best)[:, 0])


def compact_plan(plan: QueryPlan, max_slots: int) -> QueryPlan:
    """Move valid entries to the front of the slot axis and slice it to
    ``max_slots`` (lossless when the budget covers every live entry)."""
    order = torch.argsort((plan.sel_part < 0).to(torch.int32), dim=-1,
                          stable=True)
    take = lambda t: _take(t, order)[:, :max_slots]
    return QueryPlan(sel_part=take(plan.sel_part), sel_lo=take(plan.sel_lo),
                     sel_hi=take(plan.sel_hi), node=plan.node,
                     pathlen=plan.pathlen)


# ----------------------------------------------------------------------
# Planner registry + budgeted planning (the public planning API)
# ----------------------------------------------------------------------
Planner = Callable[[ClimberIndex, torch.Tensor], QueryPlan]

_PLANNERS: Dict[str, Planner] = {}


def register_planner(name: str, fn: Optional[Planner] = None):
    """Register a planner under ``name`` (usable as a decorator)."""
    if fn is None:
        return partial(register_planner, name)
    _PLANNERS[name] = fn
    return fn


def get_planner(name: str) -> Planner:
    try:
        return _PLANNERS[name]
    except KeyError:
        raise KeyError(f"unknown planner variant {name!r}; "
                       f"registered: {sorted(_PLANNERS)}") from None


def planner_names() -> Tuple[str, ...]:
    return tuple(sorted(_PLANNERS))


register_planner("knn", plan_knn)
register_planner("adaptive", plan_adaptive)
register_planner("od_smallest", plan_od_smallest)
register_planner("exhaustive", plan_exhaustive)


# -- device variants ----------------------------------------------------
# A device planner takes a mandatory ShardPlanContext:
# ``(index_view, p4_rank_q, ctx) -> QueryPlan``, runs against a padded
# skeleton, and yields the host planner's live entries in the same order —
# which is what keeps the fleet's stacked pass equal to its host loop.
# Host planners without a device variant plan on the host under mesh
# placement.
DevicePlanner = Callable[..., QueryPlan]

_DEVICE_PLANNERS: Dict[str, DevicePlanner] = {}


def register_device_planner(name: str, fn: Optional[DevicePlanner] = None):
    """Register the device (padded-skeleton) variant of planner ``name``."""
    if fn is None:
        return partial(register_device_planner, name)
    _DEVICE_PLANNERS[name] = fn
    return fn


def get_device_planner(name: str) -> Optional[DevicePlanner]:
    """Device variant of ``name``, or None (→ host planning)."""
    return _DEVICE_PLANNERS.get(name)


def device_planner_names() -> Tuple[str, ...]:
    return tuple(sorted(_DEVICE_PLANNERS))


# the four built-ins are ctx-aware host planners: one function, both paths
register_device_planner("knn", plan_knn)
register_device_planner("adaptive", plan_adaptive)
register_device_planner("od_smallest", plan_od_smallest)
register_device_planner("exhaustive", plan_exhaustive)


def _with_cfg(index, cfg):
    """The same index or shard view with ``cfg`` swapped in (an index is a
    dataclass; the fleet's ``ShardView`` is rebuilt field by field)."""
    if dataclasses.is_dataclass(index):
        return dataclasses.replace(index, cfg=cfg)
    return type(index)(cfg, index.centroid_onehot, index.trie)


def make_recall_target_planner(spend_factor: float) -> Planner:
    """An adaptive-planner variant that spends ``spend_factor`` × more.

    Scales both the coverage requirement (``cfg.k``) and the partition cap
    (``cfg.adaptive_factor``) by ``spend_factor``, rounded up, so recall
    rises with spend; ``spend_factor == 1`` is :func:`plan_adaptive` itself.
    The planner is ctx-aware (one function for the host and the device
    registry) and carries ``spend_factor`` as an attribute.
    """
    if spend_factor < 1.0:
        raise ValueError(f"spend_factor must be >= 1, got {spend_factor}")

    def planner(index, p4_rank_q: torch.Tensor,
                ctx: Optional[ShardPlanContext] = None) -> QueryPlan:
        if spend_factor == 1.0:
            return plan_adaptive(index, p4_rank_q, ctx)
        cfg = index.cfg
        boosted = cfg.replace(
            k=int(math.ceil(cfg.k * spend_factor)),
            adaptive_factor=int(math.ceil(cfg.adaptive_factor * spend_factor)))
        return plan_adaptive(_with_cfg(index, boosted), p4_rank_q, ctx)

    planner.spend_factor = spend_factor
    return planner


def register_recall_target(spend_factor: float,
                           name: str = "recall_target") -> Planner:
    """Register a recall-targeted variant under ``name`` (host + device);
    re-registering a name replaces it — a fleet must then drop its cached
    plans (``IndexFleet`` keys them on its placement epoch)."""
    planner = make_recall_target_planner(spend_factor)
    register_planner(name, planner)
    register_device_planner(name, planner)
    return planner


def default_slot_budget(index: ClimberIndex, variant: str) -> Optional[int]:
    """Tightest slot budget that is lossless for ``variant``'s plans
    (``None`` for user-registered variants: no compaction)."""
    cfg = index.cfg
    max_p = int(index.trie.part_ids_pad.shape[-1])
    t = _num_candidates(index)
    if variant == "knn":
        return max_p
    if variant == "adaptive":
        return min(2 * t * max_p, max_p * cfg.adaptive_factor)
    if variant == "od_smallest":
        return t * max_p
    if variant == "exhaustive":
        return index.store.num_partitions
    return None


def plan(index: ClimberIndex, p4_rank_q: torch.Tensor, *,
         variant: str = "adaptive", max_slots: Optional[int] = None) -> QueryPlan:
    """Run the registered planner and compact to a static slot budget
    (explicit ``max_slots`` → ``cfg.query_max_slots`` →
    :func:`default_slot_budget`)."""
    qp = get_planner(variant)(index, p4_rank_q)
    budget = max_slots if max_slots is not None else index.cfg.query_max_slots
    if budget is None:
        budget = default_slot_budget(index, variant)
    if budget is not None and budget < qp.sel_part.shape[-1]:
        qp = compact_plan(qp, budget)
    return qp


def knn_query(index: ClimberIndex, queries: torch.Tensor, k: int = 0, *,
              variant: str = "adaptive", use_kernel: Optional[bool] = None,
              mesh=None, max_slots: Optional[int] = None):
    """End-to-end approximate kNN (featurize → plan → exact refine).

    ``queries`` ``[Q, n]`` go to the index's device; ``mesh`` (a
    :class:`~repro_torch.launch.DeviceMesh` or a device list) refines
    sharded over its slots (``dispatch_refine``), with the same answer.
    Returns
    ``(dist [Q, k], gid [Q, k], plan)``: ascending ED, original row ids
    (``-1`` with :data:`repro_torch.core.refine.PAD_DIST` where fewer than k
    candidates existed), and the executed plan.
    """
    k = k or index.cfg.k
    queries = torch.as_tensor(queries, device=index.device).float()
    p4r_q, _ = index.featurize(queries)
    qp = plan(index, p4r_q, variant=variant, max_slots=max_slots)
    dist, gid = dispatch_refine(index.store, queries, qp.sel_part, qp.sel_lo,
                                qp.sel_hi, k, mesh=mesh, use_kernel=use_kernel)
    return dist, gid, qp
