"""Stacked trie skeletons — the planning inputs of the fleet's stacked pass.

The mesh placement's query pass (``MeshFleetPlacement.query``) plans
every sealed shard on its slot's device, next to the shard's partition
store, with no copy back to the host between plan and refine.  Shards are ragged
(node, edge, group and partition counts differ), so the skeletons are
padded to fleet-wide maxima with *inert* entries
(:func:`repro_torch.core.traversal.pad_trie`) and stacked on a new leading
shard axis — the trie analogue of
:func:`repro_torch.distributed.store.stack_stores`:

  * :func:`stack_tries` — ``[TrieDevice] → TrieTables [S, ...]`` (plus
    all-inert pad shards up to ``pad_to``);
  * :func:`trie_row` — one shard's ``TrieDevice`` view of the tables;
  * :func:`descend_stacked` — descent over the shard axis (a loop over
    shards where the JAX package uses ``vmap``);
  * :class:`ShardView` — the ``ClimberIndex`` stand-in the registered device
    planners (``repro_torch.core.query``) plan against.

Padding never changes a plan: pad edges never match, pad groups descend to
the inert node (size 0, no partitions), pad shards plan only ``-1``
entries.  The per-shard real counts ride along as ``[S]`` tensors and
become the :class:`~repro_torch.core.query.ShardPlanContext` counts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.traversal import TrieDevice, descend, pad_trie

_ARRAYS = TrieDevice._fields[:11]       # every field but the two static ints


class TrieTables(NamedTuple):
    """Stacked ``[S, ...]`` trie skeletons: the tensors of
    :class:`TrieDevice` with a leading shard axis, plus each shard's real
    counts (``num_pivots`` / ``num_partitions`` come back in
    :func:`trie_row`)."""

    edge_key: torch.Tensor            # [S, E] int32, pad = int32 max
    edge_child: torch.Tensor          # [S, E] int32
    has_children: torch.Tensor        # [S, N] bool
    node_size: torch.Tensor           # [S, N] float32
    node_depth: torch.Tensor          # [S, N] int32
    dfs_in: torch.Tensor              # [S, N] int32
    dfs_out: torch.Tensor             # [S, N] int32
    part_start: torch.Tensor          # [S, N + 1] int32
    part_ids_pad: torch.Tensor        # [S, N, maxP] int32, -1 padded
    group_root: torch.Tensor          # [S, G] int32, pad groups → inert node
    group_default_part: torch.Tensor  # [S, G] int32, pad = -1
    num_groups: torch.Tensor          # [S] int32 — real centroid rows
    num_partitions: torch.Tensor      # [S] int32 — real partition count

    @property
    def num_slots(self) -> int:
        return int(self.edge_key.shape[0])


def _inert_row(n1: int, emax: int, gmax: int, maxp: int, device) -> TrieDevice:
    """A whole-shard pad slot: one inert trie that plans nothing."""
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    i32 = torch.int32
    return TrieDevice(
        edge_key=full((emax,), 2**31 - 1, i32), edge_child=full((emax,), 0, i32),
        has_children=full((n1,), False, torch.bool),
        node_size=full((n1,), 0.0, torch.float32),
        node_depth=full((n1,), 0, i32), dfs_in=full((n1,), 0, i32),
        dfs_out=full((n1,), 0, i32), part_start=full((n1 + 1,), 0, i32),
        part_ids_pad=full((n1, maxp), -1, i32),
        group_root=full((gmax,), n1 - 1, i32),
        group_default_part=full((gmax,), -1, i32),
        num_pivots=0, num_partitions=0)


def stack_tries(tries: Sequence[TrieDevice], *,
                pad_to: Optional[int] = None) -> TrieTables:
    """Stack shard skeletons on a NEW leading shard axis (``S`` first).

    Ragged sizes are padded to the maxima with inert entries; the node axis
    always gains one inert node at the top index, which pad groups (and
    whole pad shards) root at.  ``pad_to`` appends all-inert pad shards up
    to that slot count; a pad shard's real counts are ``num_groups = 1`` and
    ``num_partitions = 0``, so a device planner emits only ``-1`` for it.
    """
    tries = list(tries)
    if not tries:
        raise ValueError("stack_tries needs at least one trie")
    pivs = {t.num_pivots for t in tries}
    if len(pivs) != 1:
        raise ValueError(f"tries disagree on num_pivots: {sorted(pivs)}")
    s = len(tries)
    pad_to = s if pad_to is None else pad_to
    if pad_to < s:
        raise ValueError(f"pad_to={pad_to} < {s} shards")
    n1 = max(int(t.has_children.shape[0]) for t in tries) + 1
    emax = max(int(t.edge_key.shape[0]) for t in tries)
    gmax = max(int(t.group_root.shape[0]) for t in tries)
    maxp = max(int(t.part_ids_pad.shape[1]) for t in tries)
    rows = [pad_trie(t, num_nodes=n1, num_edges=emax, max_parts=maxp,
                     num_groups=gmax) for t in tries]
    rows += [_inert_row(n1, emax, gmax, maxp, tries[0].edge_key.device)] * (pad_to - s)
    stacked = [torch.stack([getattr(r, f) for r in rows]) for f in _ARRAYS]
    dev = stacked[0].device
    g_real = [int(t.group_root.shape[0]) for t in tries] + [1] * (pad_to - s)
    p_real = [t.num_partitions for t in tries] + [0] * (pad_to - s)
    return TrieTables(*stacked,
                      num_groups=torch.tensor(g_real, dtype=torch.int32, device=dev),
                      num_partitions=torch.tensor(p_real, dtype=torch.int32, device=dev))


def trie_row(tables: TrieTables, j: int, *, num_pivots: int,
             num_partitions: int = 0) -> TrieDevice:
    """Shard ``j``'s TrieDevice view of the stacked tables (views, no copy);
    the static ints come from the caller's config."""
    return TrieDevice(*(getattr(tables, f)[j] for f in _ARRAYS),
                      num_pivots=num_pivots, num_partitions=num_partitions)


def descend_stacked(tables: TrieTables, p4_rank: torch.Tensor,
                    group: torch.Tensor, *, num_pivots: int):
    """Descent over the shard axis: row ``s`` of each output equals
    ``descend(tries[s], p4_rank[s], group[s])`` on the unstacked skeleton.

    Args:
      p4_rank: ``[S, ..., m]`` (per-shard pivots differ, so the caller
        featurizes per shard); group: ``[S, ...]``.

    Returns:
      (node, pathlen, parent), each ``[S, ...]``.
    """
    outs = [descend(trie_row(tables, s, num_pivots=num_pivots),
                    p4_rank[s], group[s]) for s in range(tables.num_slots)]
    return tuple(torch.stack(x) for x in zip(*outs))


class ShardView:
    """Duck-typed ``ClimberIndex`` stand-in for planning on the card.

    The registered planners touch ``index.cfg``, ``index.trie`` and
    ``index.centroid_onehot`` (``index.store.num_partitions`` is replaced by
    ``ShardPlanContext.p_static`` on this path), so one shard's padded rows
    are all a device planner needs.
    """

    __slots__ = ("cfg", "centroid_onehot", "trie")

    def __init__(self, cfg, centroid_onehot: torch.Tensor, trie: TrieDevice):
        self.cfg = cfg
        self.centroid_onehot = centroid_onehot
        self.trie = trie

    @property
    def num_groups(self) -> int:
        return int(self.centroid_onehot.shape[0])
