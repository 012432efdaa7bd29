"""Stacked fleet placement — the whole fleet query as one pass on the card.

The port of ``repro/fleet/placement.py`` on one device.  The host-loop
fleet query (``IndexFleet.query(placement="host")``) runs the sealed
shards one after another, each a featurize → plan → refine round trip
planned on its own.  :class:`MeshFleetPlacement` keeps the fleet's
planning inputs stacked on the card instead:

  * every shard's trie skeleton, pivots and centroid table are stacked on
    a new leading shard axis, ragged counts padded with inert entries
    (:func:`repro_torch.fleet.device_plan.stack_tries`), and the shards'
    local → fleet-global id maps form one ``[S, max records]`` table;
  * :meth:`query` runs featurize → trie descent → plan → budgeted
    compaction → routing mask → refine → global-id remap → merge for every
    shard, in shard order, with no copy to the host until the plan rows
    the fleet caches come back at the end; the answer stays on the card.

Each shard refines its own :class:`~repro_torch.core.index.PartitionStore`
(the store the host loop reads).  The JAX package stacks the stores too
(:func:`repro_torch.distributed.store.stack_stores`) so that ``shard_map``
can lay them out over a device mesh; on one card that padded second copy
would only be sliced back into the same rows, so the port keeps
``stack_stores`` for the multi-GPU placement (ROADMAP queue 1 item 7) and off
this path.

Routing is expressed in the plan: a query not routed to a shard gets that
shard's plan row masked to ``-1``, which refines to ``PAD_DIST`` / ``-1``
and loses every merge.  The device planner reproduces the host planner's
live entries in the same order, each shard's refine is the same kernel
over the same store (``refine_topk``, whose answer does not depend on the
batch or the plan width), and the merge folds shards in the host loop's
order, so the answer is the host loop's bit for bit.

The JAX package lays the stacked shards out over a device mesh with
``shard_map``; the port's "mesh" is a list of torch devices and holds
exactly one (multi-GPU placement is ROADMAP queue 1 item 7).
:meth:`dispatch` (refine only, over host-provided plans) serves the
fleet's plan-cache hits and planner variants without a device planner.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.query import (QueryPlan, ShardPlanContext,
                                    candidates_scanned, compact_plan,
                                    default_slot_budget, get_device_planner,
                                    get_planner)
from repro_torch.core.refine import PAD_DIST, merge_topk, refine
from repro_torch.fleet.device_plan import ShardView, stack_tries, trie_row
from repro_torch.kernels import ops
from repro_torch.obs import trace_annotation


def _pad_cols(x: torch.Tensor, width: int, value: int) -> torch.Tensor:
    if x.shape[-1] >= width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]), value=value)


class MeshFleetPlacement:
    """Stacked planning inputs + per-shard stores on one card.

    Built from the fleet's sealed shard list; the fleet drops and rebuilds
    it whenever that list changes.  The stacked tensors are copies of the
    shards' small planning tables; each shard's own index (its store
    included) stays authoritative and is what both placements refine.

    Args:
      mesh: a list of one torch device (the placement's card).
      shards: the fleet's ``ShardHandle`` list (order = merge order), all
        built from one :class:`~repro_torch.utils.config.ClimberConfig`.
    """

    def __init__(self, mesh: Sequence, shards):
        if not shards:
            raise ValueError("mesh placement needs at least one sealed shard")
        devices = [torch.device(d) for d in mesh]
        if len(devices) != 1:
            raise NotImplementedError(
                "the port's stacked placement runs on one card; multi-GPU "
                "placement is ROADMAP queue 1 item 7")
        self.device = dev = devices[0]
        self.num_shards = self.num_slots = len(shards)
        self._indexes = [s.index for s in shards]
        self.cfg = self._indexes[0].cfg
        if any(ix.cfg != self.cfg for ix in self._indexes):
            raise ValueError("the stacked placement plans shards of one "
                             "configuration; these differ")
        self._stores = [ix.store for ix in self._indexes]
        nmax = max(s.num_records for s in shards)
        self.global_ids = torch.full((self.num_slots, nmax), -1,
                                     dtype=torch.int32, device=dev)
        for j, s in enumerate(shards):
            self.global_ids[j, :s.num_records] = torch.from_numpy(
                np.asarray(s.global_ids, np.int32))

        # ---- planning inputs on the card --------------------------------
        tables = stack_tries([ix.trie for ix in self._indexes])
        self.tables = type(tables)(*(x.to(dev) for x in tables))
        gmax = int(tables.group_root.shape[-1])
        r = self.cfg.num_pivots
        self.pivots = torch.stack([ix.pivots for ix in self._indexes]).to(dev)
        self.centroids = torch.zeros((self.num_slots, gmax, r),
                                     dtype=torch.float32, device=dev)
        for j, ix in enumerate(self._indexes):
            self.centroids[j, :ix.num_groups] = ix.centroid_onehot
        # the real counts, on the host: planning needs no copy back
        self._g_real = [ix.num_groups for ix in self._indexes]
        self._t_real = [max(min(self.cfg.candidate_groups, g - 1), 1)
                        for g in self._g_real]
        self._p_real = [st.num_partitions for st in self._stores]
        self._t_static = min(self.cfg.candidate_groups, gmax - 1) or 1
        self._p_static = max(self._p_real)          # the widest exhaustive plan
        self._plan_widths: Dict[str, int] = {}

    def _refine_global(self, j: int, q, sel_part, sel_lo, sel_hi, k: int,
                       use_kernel: Optional[bool]):
        """Shard ``j``'s refine over its own store, local ids mapped to
        fleet-global ids on the card."""
        d, g = refine(self._stores[j], q, sel_part, sel_lo, sel_hi, k,
                      use_kernel=use_kernel)
        return d, torch.where(g >= 0, self.global_ids[j][g.clamp_min(0).long()],
                              -1)

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
        """Shard ``j``'s plan on the card for PAA features ``z [Q, w]``:
        featurize's pivot ranks, the device planner over the stacked
        skeleton with the shard's :class:`ShardPlanContext`, then live
        entries first and cut or padded to :meth:`plan_width` columns."""
        cfg = self.cfg
        b = self.plan_width(variant)
        p4r = ops.pivot_rank(z, self.pivots[j], cfg.prefix_len)
        view = ShardView(cfg, self.centroids[j], trie_row(
            self.tables, j, num_pivots=cfg.num_pivots,
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
        """One pass on the card: featurize → plan → refine → merge.

        Args:
          queries: ``[Q, n]`` raw query series.
          routed: ``[S, Q]`` bool fan-out mask; an unrouted (query, shard)
            pair gets its plan row masked to ``-1`` before refine.
          k: answer size.
          variant: a planner with a device variant
            (:meth:`supports_device_planning`).
          use_kernel: refine backend (None: the kernel on the card).

        Returns:
          ``(dist [Q, k], gid [Q, k])`` on the card — the answer, global ids
          — and ``(sel_part, sel_lo, sel_hi [S, Q, B], touched [S, Q],
          scanned [S, Q])`` host arrays — the UNMASKED per-shard plans and
          metrics, which the fleet caches.
        """
        if not self.supports_device_planning(variant):
            raise ValueError(
                f"variant {variant!r} has no device planner; use host planning")
        dev = self.device
        with trace_annotation("fleet.mesh.query"):
            q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
            route = torch.as_tensor(routed, device=dev)
            z = ops.paa(q, self.cfg.paa_segments)           # shard-independent
            best_d = torch.full((q.shape[0], k), PAD_DIST, dtype=torch.float32,
                                device=dev)
            best_g = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                                device=dev)
            outs = []
            for j in range(self.num_slots):
                qp = self.plan_shard(j, z, variant)
                # metrics of the unmasked plan, as the host loop counts them
                pt = qp.partitions_touched()
                sc = candidates_scanned(qp, self._stores[j])
                spm = torch.where(route[j][:, None], qp.sel_part, -1)
                d, g = self._refine_global(j, q, spm, qp.sel_lo, qp.sel_hi, k,
                                           use_kernel)
                best_d, best_g = merge_topk(best_d, best_g, d, g, k)
                outs.append((qp.sel_part, qp.sel_lo, qp.sel_hi, pt, sc))
            stacked = [torch.stack(x) for x in zip(*outs)]
            return (best_d, best_g,
                    *(x.cpu().numpy() for x in stacked))

    # ------------------------------------------------------------------
    # refine-only fan-out (host-computed / cache-replayed plans)
    # ------------------------------------------------------------------
    def dispatch(self, queries, sel_part: np.ndarray, sel_lo: np.ndarray,
                 sel_hi: np.ndarray, k: int,
                 use_kernel: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Refine every shard over host-provided ``[S, Q, MP]`` plans
        (``sel_part = -1`` marks pads and unrouted rows) and merge in shard
        order; returns ``(dist [Q, k], gid [Q, k])`` on the card, global
        ids."""
        dev = self.device
        with trace_annotation("fleet.mesh.dispatch"):
            q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
            sp, lo, hi = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                          for x in (sel_part, sel_lo, sel_hi))
            best_d = torch.full((q.shape[0], k), PAD_DIST, dtype=torch.float32,
                                device=dev)
            best_g = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                                device=dev)
            for j in range(self.num_slots):
                d, g = self._refine_global(j, q, sp[j], lo[j], hi[j], k,
                                           use_kernel)
                best_d, best_g = merge_topk(best_d, best_g, d, g, k)
            return best_d, best_g
