"""Vectorised trie descent — device-side counterpart of ``core.trie``.

The forest is a sorted edge-key table (``node_id * r + pivot``); descending
a rank-sensitive signature is m rounds of ``torch.searchsorted``, which
lands on the same nodes as the paper's per-object pointer walk.
:func:`pad_trie` pads a skeleton with inert entries for the fleet's
stacked planner (``repro_torch.fleet.device_plan``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.trie import TrieForest


class TrieDevice(NamedTuple):
    """Device-resident view of the skeleton."""

    edge_key: torch.Tensor          # [E] int32, sorted
    edge_child: torch.Tensor        # [E] int32
    has_children: torch.Tensor      # [num_nodes] bool
    node_size: torch.Tensor         # [num_nodes] float32
    node_depth: torch.Tensor        # [num_nodes] int32
    dfs_in: torch.Tensor            # [num_nodes] int32
    dfs_out: torch.Tensor           # [num_nodes] int32
    part_start: torch.Tensor        # [num_nodes + 1] int32
    part_ids_pad: torch.Tensor      # [num_nodes, maxP] int32, -1 padded
    group_root: torch.Tensor        # [G] int32
    group_default_part: torch.Tensor  # [G] int32
    num_pivots: int
    num_partitions: int

    @classmethod
    def from_forest(cls, f: TrieForest, device) -> "TrieDevice":
        n = f.num_nodes
        maxp = max(f.max_parts_per_node, 1)
        counts = np.diff(f.part_start)
        pad = np.full((n, maxp), -1, dtype=np.int32)
        col = np.arange(len(f.part_ids)) - np.repeat(f.part_start[:-1], counts)
        pad[np.repeat(np.arange(n), counts), col] = f.part_ids
        t = lambda a, dt=None: torch.as_tensor(
            np.ascontiguousarray(a if dt is None else a.astype(dt)),
            device=device)
        return cls(
            edge_key=t(f.edge_key, np.int32),
            edge_child=t(f.edge_child, np.int32),
            has_children=t(np.diff(f.child_start) > 0),
            node_size=t(f.node_size, np.float32),
            node_depth=t(f.node_depth, np.int32),
            dfs_in=t(f.dfs_in, np.int32),
            dfs_out=t(f.dfs_out, np.int32),
            part_start=t(f.part_start, np.int32),
            part_ids_pad=t(pad),
            group_root=t(f.group_root, np.int32),
            group_default_part=t(f.group_default_part, np.int32),
            num_pivots=int(f.num_pivots),
            num_partitions=int(f.num_partitions),
        )


def _pad1(x: torch.Tensor, width: int, value) -> torch.Tensor:
    """``x`` with ``width`` entries of ``value`` appended on axis 0."""
    tail = torch.full((width,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def pad_trie(trie: TrieDevice, *, num_nodes: int, num_edges: int,
             max_parts: int, num_groups: int) -> TrieDevice:
    """Pad a skeleton to fixed sizes with *inert* entries.

    The fleet's stacked planner (``repro_torch.fleet.device_plan``) stacks
    ragged per-shard skeletons into one ``[S, ...]`` table set; the padding
    can never change a descent or a plan:

      * edge keys pad with int32 max — a real key is ``node * r + pivot``
        below 2**31, so no probe matches a pad edge and ``searchsorted``
        still sees a sorted table;
      * the node axis pads with inert nodes (no children, size 0, empty DFS
        interval ``[0, 0)``, no partitions) — ``num_nodes`` must exceed the
        real node count so index ``num_nodes - 1`` is inert;
      * pad groups root at that inert node and default to partition ``-1``.

    Returns the padded TrieDevice (num_pivots/num_partitions unchanged).
    """
    n = int(trie.has_children.shape[0])
    e = int(trie.edge_key.shape[0])
    g = int(trie.group_root.shape[0])
    p = int(trie.part_ids_pad.shape[1])
    if num_nodes <= n:
        raise ValueError(f"num_nodes={num_nodes} must exceed the real node "
                         f"count {n} (the last index must be inert)")
    if num_edges < e or num_groups < g or max_parts < p:
        raise ValueError("pad_trie cannot shrink a skeleton")
    dn, de, dg = num_nodes - n, num_edges - e, num_groups - g
    part_ids = torch.cat([trie.part_ids_pad, torch.full(
        (n, max_parts - p), -1, dtype=torch.int32,
        device=trie.part_ids_pad.device)], dim=1)
    return TrieDevice(
        edge_key=_pad1(trie.edge_key, de, 2**31 - 1),
        edge_child=_pad1(trie.edge_child, de, 0),
        has_children=_pad1(trie.has_children, dn, False),
        node_size=_pad1(trie.node_size, dn, 0.0),
        node_depth=_pad1(trie.node_depth, dn, 0),
        dfs_in=_pad1(trie.dfs_in, dn, 0),
        dfs_out=_pad1(trie.dfs_out, dn, 0),
        part_start=_pad1(trie.part_start, dn, int(trie.part_start[-1])),
        part_ids_pad=_pad1(part_ids, dn, -1),
        group_root=_pad1(trie.group_root, dg, num_nodes - 1),
        group_default_part=_pad1(trie.group_default_part, dg, -1),
        num_pivots=trie.num_pivots,
        num_partitions=trie.num_partitions,
    )


def descend(trie: TrieDevice, p4_rank: torch.Tensor, group: torch.Tensor):
    """Walk each signature down its group's trie as far as possible.

    Args:
      p4_rank: ``[..., m]`` rank-sensitive signatures.
      group: ``[...]`` group ids.

    Returns:
      (node, pathlen, parent): landing node id (the paper's G_N), the number
      of matched prefix pivots (PathLen in Algorithm 3), and the landing
      node's parent (equal to the node itself at the root).
    """
    m = p4_rank.shape[-1]
    e = trie.edge_key.shape[0]
    node = trie.group_root[group.long()]
    parent = node
    pathlen = torch.zeros(node.shape, dtype=torch.int32, device=node.device)
    if e == 0:        # edgeless forest (tiny builds): everyone stays at root
        return node, pathlen, parent
    alive = torch.ones(node.shape, dtype=torch.bool, device=node.device)
    for d in range(m):                             # m is small and static
        key = node * trie.num_pivots + p4_rank[..., d].to(torch.int32)
        pos = torch.searchsorted(trie.edge_key, key)
        pos_c = torch.clamp(pos, max=e - 1)
        found = alive & (trie.edge_key[pos_c] == key) & (pos < e)
        parent = torch.where(found, node, parent)
        node = torch.where(found, trie.edge_child[pos_c], node)
        pathlen = pathlen + found.to(torch.int32)
        alive = found
    return node, pathlen, parent


def route_records(trie: TrieDevice, p4_rank: torch.Tensor, group: torch.Tensor):
    """Placement routing (§V Step 4).

    A record that completes a root-to-leaf walk goes to the leaf's partition
    (its own, not the group default, when the leaf's list holds both); one
    stuck at an internal node goes to its group's default partition.  Its
    dfs tag is the landing node's dfs_in.

    Returns:
      (partition, rec_dfs): ``[...]`` int32 each.
    """
    node, _, _ = descend(trie, p4_rank, group)
    nl = node.long()
    is_leaf = ~trie.has_children[nl]
    leaf_part = trie.part_ids_pad[nl, 0]
    if trie.part_ids_pad.shape[1] > 1:
        second = trie.part_ids_pad[nl, 1]
    else:   # every node lists one partition: it is the leaf's own
        second = torch.full_like(leaf_part, -1)
    default = trie.group_default_part[group.long()]
    own = torch.where((leaf_part == default) & (second >= 0), second, leaf_part)
    part = torch.where(is_leaf, own, default)
    return part.to(torch.int32), trie.dfs_in[nl]
