"""Mesh fleet placement — the whole fleet query as one pass per slot.

The port of ``repro/fleet/placement.py``.  The host-loop fleet query
(``IndexFleet.query(placement="host")``) runs the sealed shards one after
another, each a featurize → plan → refine round trip planned on its own.
:class:`MeshFleetPlacement` lays the fleet out over a
:class:`~repro_torch.launch.DeviceMesh` of D slots instead:

  * the shard axis is padded to ``S_pad``, a multiple of D, with inert pad
    shards (the reference's ``pad_store`` of the stacked stores), and slot
    d owns the shards ``[d·per, (d+1)·per)``, ``per = S_pad / D``;
  * every shard's trie skeleton, pivots and centroid table are stacked on
    a new leading shard axis, ragged counts padded with inert entries
    (:func:`repro_torch.fleet.device_plan.stack_tries`), with one
    ``[S_pad, max records]`` table of local → fleet-global ids; each slot
    holds its rows of them on its device;
  * each slot refines the store
    (:class:`~repro_torch.core.index.PartitionStore`) of every shard it
    owns, the store the host loop reads: the index's own tensors where the
    slot is their device, one copy per owned shard on another device,
    dropped with the placement;
  * :meth:`query` runs featurize → trie descent → plan → budgeted
    compaction → routing mask → refine → global-id remap → in-order fold
    for every owned shard on each slot's device.  Every slot is launched
    before the first gather; the slots' answers then meet on the lead
    device and fold in slot order, with no copy to the host until the plan
    rows the fleet caches come back at the end.

Routing is expressed in the plan: a query not routed to a shard gets that
shard's plan row masked to ``-1``, which refines to ``PAD_DIST`` / ``-1``
and loses every merge; a pad shard plans nothing and is not run.  The
device planner reproduces the host planner's live entries in the same
order, each shard's refine is the same kernel over the same store
(``refine_topk``, whose answer does not depend on the batch or the plan
width), and ``merge_topk`` ranks by (distance, shard, position) whether it
folds shards one by one or slot by slot, so the answer is the host loop's
bit for bit on any D.

:meth:`dispatch` (refine only, over host-provided plans) serves the
fleet's plan-cache hits and planner variants without a device planner.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import PartitionStore
from repro_torch.core.query import (QueryPlan, ShardPlanContext,
                                    candidates_scanned, compact_plan,
                                    default_slot_budget, get_device_planner,
                                    get_planner)
from repro_torch.core.refine import PAD_DIST, merge_topk, refine
from repro_torch.distributed.store import to_device
from repro_torch.fleet.device_plan import (ShardView, TrieTables, stack_tries,
                                           trie_row)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import as_mesh
from repro_torch.obs import trace_annotation


def _pad_cols(x: torch.Tensor, width: int, value: int) -> torch.Tensor:
    if x.shape[-1] >= width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]), value=value)


def _fold(lists, qn: int, k: int, device):
    """Merge ``(dist, gid)`` lists in order, from an all-pad start."""
    best_d = torch.full((qn, k), PAD_DIST, dtype=torch.float32, device=device)
    best_g = torch.full((qn, k), -1, dtype=torch.int32, device=device)
    for d, g in lists:
        best_d, best_g = merge_topk(best_d, best_g, d.to(device),
                                    g.to(device), k)
    return best_d, best_g


class _Slot(NamedTuple):
    """One slot's share of the fleet, on its device: rows ``[d·per,
    (d+1)·per)`` of the stacked planning tables, and the stores of its
    real shards (``shards``, global shard ids)."""

    device: torch.device
    shards: List[int]
    base: int
    tables: TrieTables
    pivots: torch.Tensor            # [per, r, w]
    centroids: torch.Tensor         # [per, G, r]
    global_ids: torch.Tensor        # [per, max records]
    stores: List[PartitionStore]


class MeshFleetPlacement:
    """Stacked planning inputs + per-shard stores over the mesh's slots.

    Built from the fleet's sealed shard list; the fleet drops and rebuilds
    it whenever that list or the mesh changes.  The stacked tensors are
    copies of the shards' small planning tables; each shard's own index
    stays authoritative and is what both placements refine.

    Args:
      mesh: a :class:`~repro_torch.launch.DeviceMesh` or a device list.
      shards: the fleet's ``ShardHandle`` list (order = merge order), all
        built from one :class:`~repro_torch.utils.config.ClimberConfig`.
    """

    def __init__(self, mesh, shards):
        if not shards:
            raise ValueError("mesh placement needs at least one sealed shard")
        self.mesh = mesh = as_mesh(mesh)
        self.num_shards = s_real = len(shards)
        self.per = per = -(-s_real // mesh.size)
        self.num_slots = per * mesh.size            # S_pad
        self._indexes = [s.index for s in shards]
        self.cfg = self._indexes[0].cfg
        if any(ix.cfg != self.cfg for ix in self._indexes):
            raise ValueError("the stacked placement plans shards of one "
                             "configuration; these differ")
        home = self._indexes[0].device
        self._stores = [ix.store for ix in self._indexes]
        nmax = max(s.num_records for s in shards)
        self.global_ids = torch.full((self.num_slots, nmax), -1,
                                     dtype=torch.int32, device=home)
        for j, s in enumerate(shards):
            self.global_ids[j, :s.num_records] = torch.from_numpy(
                np.asarray(s.global_ids, np.int32))

        # ---- planning inputs, stacked on the shards' device --------------
        self.tables = stack_tries([ix.trie for ix in self._indexes],
                                  pad_to=self.num_slots)
        gmax = int(self.tables.group_root.shape[-1])
        r, w = self.cfg.num_pivots, self.cfg.paa_segments
        self.pivots = torch.zeros((self.num_slots, r, w), dtype=torch.float32,
                                  device=home)
        self.centroids = torch.zeros((self.num_slots, gmax, r),
                                     dtype=torch.float32, device=home)
        for j, ix in enumerate(self._indexes):
            self.pivots[j] = ix.pivots
            self.centroids[j, :ix.num_groups] = ix.centroid_onehot
        # the real counts, on the host: planning needs no copy back
        self._g_real = [ix.num_groups for ix in self._indexes]
        self._t_real = [max(min(self.cfg.candidate_groups, g - 1), 1)
                        for g in self._g_real]
        self._p_real = [st.num_partitions for st in self._stores]
        self._t_static = min(self.cfg.candidate_groups, gmax - 1) or 1
        self._p_static = max(self._p_real)          # the widest exhaustive plan
        self._plan_widths: Dict[str, int] = {}

        # ---- each slot's rows on its device (views where it is home) -----
        self._slots: List[_Slot] = []
        for d, dev in enumerate(mesh.slots):
            rows = slice(d * per, (d + 1) * per)
            put = lambda x: x[rows].to(dev)
            owned = list(range(d * per, min((d + 1) * per, s_real)))
            self._slots.append(_Slot(
                device=dev, shards=owned, base=d * per,
                tables=TrieTables(*(put(x) for x in self.tables)),
                pivots=put(self.pivots), centroids=put(self.centroids),
                global_ids=put(self.global_ids),
                stores=[to_device(self._stores[j], dev) for j in owned]))

    def _slot_of(self, j: int) -> Tuple[_Slot, int]:
        """The slot owning shard ``j`` and ``j``'s row in it."""
        return self._slots[j // self.per], j % self.per

    def _refine_global(self, j: int, q, sel_part, sel_lo, sel_hi, k: int,
                       use_kernel: Optional[bool]):
        """Shard ``j``'s refine over its store on its slot's device, local
        ids mapped to fleet-global ids there."""
        slot, jl = self._slot_of(j)
        d, g = refine(slot.stores[jl], q, sel_part, sel_lo, sel_hi, k,
                      use_kernel=use_kernel)
        gmap = slot.global_ids[jl]
        return d, torch.where(g >= 0, gmap[g.clamp_min(0).long()], -1)

    # ------------------------------------------------------------------
    # planning on the card (the stacked pass)
    # ------------------------------------------------------------------
    def supports_device_planning(self, variant: str) -> bool:
        """True when ``variant`` has a registered device planner."""
        return get_device_planner(variant) is not None

    def plan_width(self, variant: str) -> int:
        """B — the stacked pass's plan width for ``variant``: the most, over
        shards, of the width the host planner's :func:`plan` produces after
        its budget, so a device plan row compacted to B holds exactly the
        host plan's live entries.  Measured once per variant by planning
        one dummy row per shard."""
        b = self._plan_widths.get(variant)
        if b is None:
            widths = []
            for ix in self._indexes:
                p4 = torch.zeros((1, ix.cfg.prefix_len), dtype=torch.int32,
                                 device=ix.device)
                raw = int(get_planner(variant)(ix, p4).sel_part.shape[-1])
                budget = ix.cfg.query_max_slots
                if budget is None:
                    budget = default_slot_budget(ix, variant)
                widths.append(raw if budget is None else min(budget, raw))
            b = self._plan_widths[variant] = max(widths)
        return b

    def plan_shard(self, j: int, z: torch.Tensor, variant: str) -> QueryPlan:
        """Shard ``j``'s plan on its slot's device for PAA features
        ``z [Q, w]``: featurize's pivot ranks, the device planner over the
        stacked skeleton with the shard's :class:`ShardPlanContext`, then
        live entries first and cut or padded to :meth:`plan_width`
        columns."""
        cfg = self.cfg
        b = self.plan_width(variant)
        slot, jl = self._slot_of(j)
        p4r = ops.pivot_rank(z.to(slot.device), slot.pivots[jl],
                             cfg.prefix_len)
        view = ShardView(cfg, slot.centroids[jl], trie_row(
            slot.tables, jl, num_pivots=cfg.num_pivots,
            num_partitions=self._p_static))
        ctx = ShardPlanContext(
            num_groups=self._g_real[j], num_candidates=self._t_real[j],
            num_partitions=self._p_real[j], t_static=self._t_static,
            p_static=self._p_static)
        qp = get_device_planner(variant)(view, p4r, ctx)
        if qp.sel_part.shape[-1] > b:               # live first, the host's drops
            qp = compact_plan(qp, b)
        return QueryPlan(sel_part=_pad_cols(qp.sel_part, b, -1),
                         sel_lo=_pad_cols(qp.sel_lo, b, 0),
                         sel_hi=_pad_cols(qp.sel_hi, b, 0),
                         node=qp.node, pathlen=qp.pathlen)

    def query(self, queries, routed: np.ndarray, k: int, *,
              variant: str = "adaptive", use_kernel: Optional[bool] = None):
        """One pass per slot: featurize → plan → refine → fold, then one
        fold of the slots' answers on the lead device.

        Args:
          queries: ``[Q, n]`` raw query series.
          routed: ``[S_pad, Q]`` bool fan-out mask (pad-shard rows False);
            an unrouted (query, shard) pair gets its plan row masked to
            ``-1`` before refine.
          k: answer size.
          variant: a planner with a device variant
            (:meth:`supports_device_planning`).
          use_kernel: refine backend (None: the kernel on the card).

        Returns:
          ``(dist [Q, k], gid [Q, k])`` on the lead device — the answer,
          global ids — and ``(sel_part, sel_lo, sel_hi [S_pad, Q, B],
          touched [S_pad, Q], scanned [S_pad, Q])`` host arrays — the
          UNMASKED per-shard plans and metrics (pad shards: ``-1`` / 0),
          which the fleet caches.
        """
        if not self.supports_device_planning(variant):
            raise ValueError(
                f"variant {variant!r} has no device planner; use host planning")
        qn = len(queries)
        lead = self.mesh.lead
        with trace_annotation("fleet.mesh.query"):
            # one upload to the lead device: a copy from host memory waits
            # for its stream, a copy between devices does not
            q_lead = torch.as_tensor(queries, dtype=torch.float32, device=lead)
            route_lead = torch.as_tensor(routed, device=lead)
            answers, plans = [], {}
            for slot in self._slots:                # launch every slot first
                if not slot.shards:
                    continue
                q = q_lead.to(slot.device)
                route = route_lead.to(slot.device)
                z = ops.paa(q, self.cfg.paa_segments)   # shard-independent
                lists, outs = [], []
                for j in slot.shards:
                    qp = self.plan_shard(j, z, variant)
                    # metrics of the unmasked plan, as the host loop counts
                    pt = qp.partitions_touched()
                    sc = candidates_scanned(qp, slot.stores[j - slot.base])
                    spm = torch.where(route[j][:, None], qp.sel_part, -1)
                    lists.append(self._refine_global(
                        j, q, spm, qp.sel_lo, qp.sel_hi, k, use_kernel))
                    outs.append((qp.sel_part, qp.sel_lo, qp.sel_hi, pt, sc))
                answers.append(_fold(lists, qn, k, slot.device))
                plans[slot.base] = [torch.stack(x) for x in zip(*outs)]
            best_d, best_g = _fold(answers, qn, k, lead)
            return (best_d, best_g, *self._host_plans(plans))

    def _host_plans(self, plans: Dict[int, list]):
        """Per-slot ``[owned, ...]`` plan stacks → ``[S_pad, ...]`` host
        arrays, pad shards ``-1`` (``sel_part``) or 0: assembled on the
        lead device, one copy to the host per field."""
        lead = self.mesh.lead
        first = next(iter(plans.values()))
        out = []
        for f, fill in enumerate((-1, 0, 0, 0, 0)):
            a = torch.full((self.num_slots,) + tuple(first[f].shape[1:]), fill,
                           dtype=first[f].dtype, device=lead)
            for base, xs in plans.items():
                a[base: base + xs[f].shape[0]] = xs[f].to(lead)
            out.append(a.cpu().numpy())
        return out

    # ------------------------------------------------------------------
    # refine-only fan-out (host-computed / cache-replayed plans)
    # ------------------------------------------------------------------
    def dispatch(self, queries, sel_part: np.ndarray, sel_lo: np.ndarray,
                 sel_hi: np.ndarray, k: int,
                 use_kernel: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Refine every shard over host-provided ``[S_pad, Q, MP]`` plans
        (``sel_part = -1`` marks pads and unrouted rows) on its slot, fold
        per slot and then across slots in shard order; returns
        ``(dist [Q, k], gid [Q, k])`` on the lead device, global ids."""
        qn = len(queries)
        lead = self.mesh.lead
        with trace_annotation("fleet.mesh.dispatch"):
            q_lead = torch.as_tensor(queries, dtype=torch.float32, device=lead)
            plan = [torch.as_tensor(x, dtype=torch.int32, device=lead)
                    for x in (sel_part, sel_lo, sel_hi)]
            answers = []
            for slot in self._slots:
                if not slot.shards:
                    continue
                dev = slot.device
                q = q_lead.to(dev)
                rows = slice(slot.shards[0], slot.shards[-1] + 1)
                sp, lo, hi = (x[rows].to(dev) for x in plan)
                answers.append(_fold(
                    [self._refine_global(j, q, sp[i], lo[i], hi[i], k,
                                         use_kernel)
                     for i, j in enumerate(slot.shards)], qn, k, dev))
            return _fold(answers, qn, k, self.mesh.lead)
