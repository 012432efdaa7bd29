"""Vectorised trie descent — device-side counterpart of ``core.trie``.

The forest is a sorted edge-key table (``node_id * r + pivot``); descending
a rank-sensitive signature is m rounds of ``torch.searchsorted``, which
lands on the same nodes as the paper's per-object pointer walk.  The fleet's
``pad_trie`` is not ported yet.
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
