"""Localized record-level similarity — paper §VI (final refine stage).

Given the partitions + trie-node targets the planner selected, rank every
record of those targets by exact ED and keep the k best.  Backends, behind
:func:`dispatch_refine`:

  * the fused kernel (``kernels.refine_topk`` via
    ``ops.fused_refine_topk_device_plan``): masked distance + k-best
    straight off the store, nothing of shape ``[Q, slots, cap]``
    materialised.  On a CPU tensor the same wrapper runs its plain version;
  * the dense path: gathers the selected rows, takes their dots with the
    queries through ``ops.batched_query_dots`` (the ``qdots`` kernel on the
    card, its plain version on the CPU), masks the full distance tensor,
    stable top-k — the parity oracle.

Either store layout (``core.index``: dense :class:`PartitionStore`, or
:class:`RaggedStore`) goes through both backends, which address it
through its ``ragged`` offsets (None for a dense store); a ragged store
answers as its dense counterpart, bit for bit.  The sharded refine takes
dense stores only.

``use_kernel=None`` resolves by the store's device (:func:`default_use_kernel`):
the kernel on CUDA, the dense path on the CPU.  ``use_kernel=False`` is the
only way a CUDA tensor reaches the dense path.

:func:`refine_sharded` runs the same refine over a store laid out on a
:class:`~repro_torch.launch.DeviceMesh` (``shard_store``): each slot refines
its own partitions on its device, the slots' lists are gathered to the lead
device and merged once.  The merge sorts on d² stably in slot order and
takes the square root last, which is the one-device kernel's own order
(d², then flat index: partitions sort by id, and slot d holds lower ids
than slot d + 1), so the sharded answer equals :func:`refine`'s bit for
bit.  Merging the square roots instead (the JAX package's merge) would tie
two records whose d² differ by one ulp and order them by slot.

Duplicate coverage (a node and its ancestor both selected) is removed by a
sorted-slot segmented scan: plan entries are sorted by partition id, and a
record is dropped when an earlier entry of the same partition included it.
The scan (the JAX package's ``_dedupe_segments``) is
``kernels.refine_topk.dedupe_segments``, shared by the dense path and the
kernel's plain version; the CUDA kernel evaluates the same predicate.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.index import PartitionStore, Store
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.refine_topk import PAD_D2, masked_distances, topk_flat
from repro_torch.launch.mesh import as_mesh
from repro_torch.utils import roofline as RL

# Sentinel distance of a pad answer (gid = -1): both refine paths emit
# sqrt(PAD_D2) for slots with fewer than k candidates.
PAD_DIST = float(np.sqrt(np.float32(3.4e38)))


def default_use_kernel(device) -> bool:
    """Backend default for the refine implementation: the fused kernel for
    a store on the card (and on ``meta``, a dry-run of the card's route),
    the dense path on the CPU."""
    return torch.device(device).type in ("cuda", "meta")


def resolve_use_kernel(use_kernel: Optional[bool], device) -> bool:
    """``None`` → the device default; explicit flags are honoured as-is."""
    return default_use_kernel(device) if use_kernel is None else bool(use_kernel)


def _sort_by_partition(sel_part, sel_lo, sel_hi):
    """Stable-sort plan entries by partition id (pads first, ties by entry
    order) so duplicate coverage is detectable by a segmented scan."""
    order = torch.argsort(sel_part, dim=-1, stable=True)
    take = lambda t: torch.gather(t, 1, order)
    return take(sel_part), take(sel_lo), take(sel_hi)


def _masked_distances(store: Store, queries, sel_part, sel_lo, sel_hi):
    """Dense ``[Q, MP·cap]`` masked squared ED and gids (the oracle)."""
    sel_part, sel_lo, sel_hi = _sort_by_partition(sel_part, sel_lo, sel_hi)
    return masked_distances(store.data, store.norms, store.rec_dfs,
                            store.rec_gid, queries, sel_part, sel_lo, sel_hi,
                            dot_fn=kernel_ops.batched_query_dots,
                            ragged=store.ragged)


def refine(store: Store, queries: torch.Tensor, sel_part: torch.Tensor,
           sel_lo: torch.Tensor, sel_hi: torch.Tensor, k: int,
           *, use_kernel: Optional[bool] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-ED top-k within the selected (partition, node) targets.

    Returns:
      (dist, gid): ``[Q, k]`` ascending ED (not squared) and record ids
      (−1 where fewer than k candidates existed; their distance is the
      :data:`PAD_DIST` sentinel on both paths).
    """
    return _finish(*_refine_d2(store, queries, sel_part, sel_lo, sel_hi, k,
                               use_kernel))


def _refine_d2(store: Store, queries, sel_part, sel_lo, sel_hi,
               k: int, use_kernel: Optional[bool]):
    """``(d² [Q, k], gid [Q, k])`` by (d², flat index), on the store's
    device: the refine before its square root."""
    if resolve_use_kernel(use_kernel, store.data.device):
        return kernel_ops.fused_refine_topk_device_plan(
            store.data, store.norms, store.rec_dfs, store.rec_gid,
            queries, sel_part, sel_lo, sel_hi, k, ragged=store.ragged)
    return topk_flat(*_masked_distances(store, queries, sel_part, sel_lo,
                                        sel_hi), k)


def _finish(d2: torch.Tensor, gid: torch.Tensor):
    """ED and gids of a d² list: ``PAD_DIST`` / ``-1`` past the pool."""
    return torch.sqrt(d2), torch.where(d2 >= PAD_D2, -1, gid)


def merge_topk(dist_a, gid_a, dist_b, gid_b, k: int, *, dedupe: bool = False):
    """Merge two per-query top-k lists into one ``[..., k]`` top-k.

    Ties break toward input a, then slot order (the ``jax.lax.top_k``
    lowest-index rule).  Pad entries (``gid = -1``) must carry
    :data:`PAD_DIST`.  ``dedupe=True`` keeps only the best-ranked copy of
    each gid (O(k²) pairwise compares).

    Example — fusing two shards' answers::

        >>> import torch
        >>> d, g = merge_topk(torch.tensor([[1.0, 3.0]]), torch.tensor([[10, 11]]),
        ...                   torch.tensor([[2.0, PAD_DIST]]), torch.tensor([[20, -1]]), k=3)
        >>> g.tolist()
        [[10, 20, 11]]
    """
    dist = torch.cat([dist_a, dist_b], dim=-1)
    gid = torch.cat([gid_a, gid_b], dim=-1)
    if dedupe:
        # entry j dominates entry i when they carry the same real gid and j
        # ranks strictly better: smaller distance, or equal and earlier
        same = (gid[..., :, None] == gid[..., None, :]) & (gid[..., None, :] >= 0)
        d_i, d_j = dist[..., :, None], dist[..., None, :]
        n2 = dist.shape[-1]
        ar = torch.arange(n2, device=dist.device)
        earlier = ar[None, :] < ar[:, None]                     # j < i
        dominated = torch.any(same & ((d_j < d_i) | ((d_j == d_i) & earlier)),
                              dim=-1)
        dist = torch.where(dominated, torch.full_like(dist, PAD_DIST), dist)
        gid = torch.where(dominated, torch.full_like(gid, -1), gid)
    if dist.shape[-1] < k:
        pad = k - dist.shape[-1]
        dist = torch.nn.functional.pad(dist, (0, pad), value=PAD_DIST)
        gid = torch.nn.functional.pad(gid, (0, pad), value=-1)
    order = torch.sort(dist, dim=-1, stable=True).indices[..., :k]
    return torch.gather(dist, -1, order), torch.gather(gid, -1, order)


def refine_sharded(store: PartitionStore, queries: torch.Tensor,
                   sel_part: torch.Tensor, sel_lo: torch.Tensor,
                   sel_hi: torch.Tensor, k: int, *, mesh,
                   use_kernel: Optional[bool] = None,
                   slots: Optional[Sequence[PartitionStore]] = None):
    """Refine over ``store`` laid out on ``mesh``: a local refine per slot,
    one gather to the lead device, one merge.

    Global partition ids in ``sel_part`` become slot-local ids (``-1`` off
    the slot).  Every slot's refine is launched before the first gather,
    each on its device's current stream, so distinct cards overlap and the
    cross-device copies order themselves after their producers.

    Args:
      store: the whole store (its partition count fixes the layout).
      mesh: a :class:`~repro_torch.launch.DeviceMesh` or a device list.
      slots: ``shard_store(store, mesh)`` when the caller laid the store
        out once already (the serving engine); laid out here otherwise.

    Returns ``(dist, gid)`` on the lead device, equal to :func:`refine`'s
    bit for bit.
    """
    # imported here: distributed.store imports core.index, whose package
    # imports this module
    from repro_torch.distributed.store import shard_store, slot_range

    mesh = as_mesh(mesh)
    if slots is None:
        slots = shard_store(store, mesh)
    parts: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for d, (dev, st) in enumerate(zip(mesh.slots, slots)):
        lo, hi = slot_range(store.num_partitions, mesh.size, d)
        if hi == lo:
            continue                    # an inert slot: nothing to refine
        sp = sel_part.to(dev)
        sp_local = torch.where((sp >= lo) & (sp < hi), sp - lo, -1)
        parts.append(_refine_d2(st, queries.to(dev), sp_local,
                                sel_lo.to(dev), sel_hi.to(dev), k,
                                use_kernel))
    lead = mesh.lead
    # the slots' lists gathered to the lead: an all-gather's bytes under a
    # cost counter (one result, on the lead)
    with RL.collective("all-gather") as moved:
        d2 = torch.cat([p[0].to(lead) for p in parts], dim=-1)
        gid = torch.cat([p[1].to(lead) for p in parts], dim=-1)
        moved += [d2, gid]
    return _finish(*topk_flat(d2, gid, k))


def dispatch_refine(store: Store, queries: torch.Tensor,
                    sel_part: torch.Tensor, sel_lo: torch.Tensor,
                    sel_hi: torch.Tensor, k: int, *, mesh=None,
                    use_kernel: Optional[bool] = None,
                    slots: Optional[Sequence[PartitionStore]] = None):
    """Single execution-dispatch layer for the query stack.

    ``mesh=None`` or a one-device mesh runs :func:`refine` on the store's
    device; a mesh of more slots runs :func:`refine_sharded` (``slots`` as
    there).  Both return ``[Q, k]`` ascending ED and gids with the
    :data:`PAD_DIST` / ``-1`` sentinel, equal bit for bit.
    """
    mesh = as_mesh(mesh)
    if mesh is not None and mesh.size > 1:
        return refine_sharded(store, queries, sel_part, sel_lo, sel_hi, k,
                              mesh=mesh, use_kernel=use_kernel, slots=slots)
    return refine(store, queries, sel_part, sel_lo, sel_hi, k,
                  use_kernel=use_kernel)
