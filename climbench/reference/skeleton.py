"""The index skeleton on the host, in numpy: Algorithm 2's centroids
(§V Step 2), the per-group tries over rank-sensitive prefixes and their
First-Fit-Decreasing leaf packing (§IV-D, §V Step 3, Def. 13).

A frozen copy of ``repro_torch.core.{centroids,trie,packing}`` as they stood
when the benchmark was written: the algorithms are host code whose result
is fixed by the sample's signatures, so the reference runs the same steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def ffd_pack(sizes: Sequence[float], capacity: float) -> Tuple[np.ndarray, int]:
    """First-Fit-Decreasing bin packing.

    Args:
      sizes: per-leaf estimated sizes.
      capacity: c.

    Returns:
      (assignment, num_bins): ``assignment[i]`` is the bin id of leaf i
      (bin ids are dense in [0, num_bins)).
    """
    sizes = np.asarray(sizes, dtype=np.float64)
    n = sizes.shape[0]
    assignment = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return assignment, 0

    order = np.argsort(-sizes, kind="stable")       # decreasing
    bin_load: List[float] = []
    for i in order:
        s = float(sizes[i])
        placed = False
        for b, load in enumerate(bin_load):         # first fit
            if load + s <= capacity:
                bin_load[b] = load + s
                assignment[i] = b
                placed = True
                break
        if not placed:                              # open a new bin
            assignment[i] = len(bin_load)
            bin_load.append(s)
    return assignment, len(bin_load)


@dataclass
class CentroidSet:
    """Skeleton-level output of Algorithm 2.

    onehot:  [G, r] float32 bitset rows; row 0 is the all-zeros fall-back.
    sigs:    [G, m] int32; row 0 is all -1 (fall-back has no members a priori).
    """

    onehot: np.ndarray
    sigs: np.ndarray

    @property
    def num_groups(self) -> int:
        return self.onehot.shape[0]


def aggregate_signatures(p4_set: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """List L of Algorithm 2: unique rank-insensitive signatures + frequencies."""
    uniq, counts = np.unique(np.asarray(p4_set), axis=0, return_counts=True)
    return uniq.astype(np.int32), counts.astype(np.int64)


def _overlap_dist_np(a: np.ndarray, b: np.ndarray, m: int) -> int:
    """OD between two set signatures (host-side helper)."""
    return int(m - np.intersect1d(a, b, assume_unique=True).size)


def compute_centroids(
    p4_set_sample: np.ndarray,
    num_pivots: int,
    *,
    sample_frac: float,
    capacity: int,
    min_od: int = 2,
    max_centroids: int = 0,
) -> CentroidSet:
    """Algorithm 2.

    Args:
      p4_set_sample: ``[S, m]`` rank-insensitive signatures of the sample.
      num_pivots: r.
      sample_frac: α ∈ (0,1].
      capacity: c (storage capacity constraint).
      min_od: ε — signatures closer than this to an accepted centroid are
        skipped (Alg. 2 lines 5–9 use strict ``<``).
      max_centroids: optional stopping condition (0 = unlimited).

    Returns:
      CentroidSet with the fall-back group at index 0.
    """
    sigs, freqs = aggregate_signatures(p4_set_sample)
    m = sigs.shape[1]
    order = np.argsort(-freqs, kind="stable")           # line 2: sort desc
    sigs, freqs = sigs[order], freqs[order]

    chosen: list[int] = []
    total_freq = int(freqs.sum())

    for i in range(len(sigs)):
        if not chosen:
            chosen.append(i)                            # line 3: L[0]
            continue
        # line 5-9: too close to an existing centroid -> skip this candidate
        too_close = any(
            _overlap_dist_np(sigs[i], sigs[j], m) < min_od for j in chosen
        )
        if too_close:
            continue
        # line 10-13: avoid tiny groups.  Estimated membership assumes the
        # remaining (non-centroid) mass spreads uniformly over the current
        # centroids (+1 for the candidate itself).
        chosen_freq = int(freqs[list(chosen)].sum())
        size_est = freqs[i] + (total_freq - chosen_freq - freqs[i]) / (len(chosen) + 1)
        if size_est < sample_frac * capacity:
            break                                        # S_c is final
        chosen.append(i)
        if max_centroids and len(chosen) == max_centroids:
            break

    g = len(chosen) + 1                                  # +1 fall-back (line 17)
    onehot = np.zeros((g, num_pivots), dtype=np.float32)
    out_sigs = np.full((g, m), -1, dtype=np.int32)
    for gi, idx in enumerate(chosen, start=1):
        onehot[gi, sigs[idx]] = 1.0
        out_sigs[gi] = sigs[idx]
    return CentroidSet(onehot=onehot, sigs=out_sigs)


@dataclass
class TrieForest:
    """Flattened forest: one trie per group, shared node/edge tables."""

    # topology (CSR: edges of node i live in [child_start[i], child_start[i+1]))
    child_start: np.ndarray     # [num_nodes + 1] int32
    edge_pivot: np.ndarray      # [E] int32 — sorted within each node's range
    edge_child: np.ndarray      # [E] int32
    edge_key: np.ndarray        # [E] int64 — node_id * r + pivot (globally sorted)

    # node attributes
    node_size: np.ndarray       # [num_nodes] float64 — estimated subtree size
    node_depth: np.ndarray      # [num_nodes] int32
    dfs_in: np.ndarray          # [num_nodes] int32
    dfs_out: np.ndarray         # [num_nodes] int32

    # node -> partitions (CSR over distinct partition ids of the subtree)
    part_start: np.ndarray      # [num_nodes + 1] int32
    part_ids: np.ndarray        # [sum] int32

    # per-group
    group_root: np.ndarray      # [G] int32
    group_default_part: np.ndarray  # [G] int32

    num_partitions: int
    num_pivots: int             # r — for edge keys
    max_parts_per_node: int     # static bound used by the query planner

    @property
    def num_nodes(self) -> int:
        return self.node_size.shape[0]

    def node_partitions(self, node: int) -> np.ndarray:
        return self.part_ids[self.part_start[node]: self.part_start[node + 1]]


class _Node:
    __slots__ = ("depth", "entries", "children", "size", "nid", "part_set")

    def __init__(self, depth: int):
        self.depth = depth
        self.entries: List[Tuple[np.ndarray, float]] = []  # (sig, scaled freq)
        self.children: Dict[int, "_Node"] = {}
        self.size = 0.0
        self.nid = -1
        self.part_set: List[int] = []


def _split(node: _Node, capacity: float, max_depth: int) -> None:
    """Recursive trie split (paper Fig. 5): distribute by the depth-th pivot."""
    node.size = sum(f for _, f in node.entries)
    if node.size <= capacity or node.depth >= max_depth:
        return                                           # leaf
    for sig, f in node.entries:
        p = int(sig[node.depth])
        child = node.children.get(p)
        if child is None:
            child = node.children[p] = _Node(node.depth + 1)
        child.entries.append((sig, f))
    for child in node.children.values():
        _split(child, capacity, max_depth)


def build_forest(
    p4_rank: np.ndarray,
    freqs: np.ndarray,
    groups: np.ndarray,
    num_groups: int,
    num_pivots: int,
    *,
    capacity: float,
    sample_frac: float,
) -> TrieForest:
    """Build the partition skeleton from the sample's rank-sensitive sigs.

    Args:
      p4_rank: ``[S, m]`` sample signatures (aggregated or raw).
      freqs: ``[S]`` frequencies (1 for raw rows).
      groups: ``[S]`` group id of every signature (Algorithm 1 output).
      num_groups: G (including fall-back group 0).
      num_pivots: r.
      capacity: c.
      sample_frac: α — sample counts are scaled by 1/α for size estimates (§V).
    """
    p4_rank = np.asarray(p4_rank)
    freqs = np.asarray(freqs, dtype=np.float64) / sample_frac
    groups = np.asarray(groups)
    m = p4_rank.shape[1]

    # -- per-group trie construction ------------------------------------
    roots: List[_Node] = []
    for g in range(num_groups):
        root = _Node(0)
        sel = np.nonzero(groups == g)[0]
        root.entries = [(p4_rank[i], float(freqs[i])) for i in sel]
        _split(root, capacity, m)
        roots.append(root)

    # -- flatten with DFS numbering --------------------------------------
    nodes: List[_Node] = []

    def dfs_assign(nd: _Node):
        nd.nid = len(nodes)
        nodes.append(nd)
        for p in sorted(nd.children):
            dfs_assign(nd.children[p])

    group_root = np.zeros(num_groups, dtype=np.int32)
    for g, root in enumerate(roots):
        group_root[g] = len(nodes)
        dfs_assign(root)

    n_nodes = len(nodes)
    child_start = np.zeros(n_nodes + 1, dtype=np.int32)
    edge_pivot: List[int] = []
    edge_child: List[int] = []
    node_size = np.zeros(n_nodes, dtype=np.float64)
    node_depth = np.zeros(n_nodes, dtype=np.int32)
    dfs_in = np.zeros(n_nodes, dtype=np.int32)
    dfs_out = np.zeros(n_nodes, dtype=np.int32)

    counter = [0]

    def dfs_intervals(nd: _Node):
        dfs_in[nd.nid] = counter[0]
        counter[0] += 1
        for p in sorted(nd.children):
            dfs_intervals(nd.children[p])
        dfs_out[nd.nid] = counter[0]

    for root in roots:
        dfs_intervals(root)

    for nd in nodes:
        node_size[nd.nid] = nd.size
        node_depth[nd.nid] = nd.depth
        child_start[nd.nid + 1] = len(nd.children)
        for p in sorted(nd.children):
            edge_pivot.append(p)
            edge_child.append(nd.children[p].nid)
    child_start = np.cumsum(child_start).astype(np.int32)
    edge_pivot_a = np.asarray(edge_pivot, dtype=np.int32)
    edge_child_a = np.asarray(edge_child, dtype=np.int32)
    # Edge keys: node ids ascend along the edge list and pivots ascend within
    # a node, so the concatenated key array is globally sorted already.
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), np.diff(child_start))
    edge_key = src * num_pivots + edge_pivot_a.astype(np.int64)
    assert np.all(np.diff(edge_key) > 0), "edge keys must be strictly sorted"
    # int32 keys keep the device tables compact; guard the range.
    assert n_nodes * num_pivots < 2**31, "trie too large for int32 edge keys"
    edge_key = edge_key.astype(np.int32)

    # -- FFD packing of leaves, per group (paper packs within a group) ----
    part_of_leaf: Dict[int, int] = {}
    group_default = np.zeros(num_groups, dtype=np.int32)
    next_pid = 0
    for g, root in enumerate(roots):
        leaves: List[_Node] = []

        def collect(nd: _Node):
            if not nd.children:
                leaves.append(nd)
            for p in sorted(nd.children):
                collect(nd.children[p])

        collect(root)
        sizes = [nd.size for nd in leaves]
        assign, nbins = ffd_pack(sizes, capacity)
        nbins = max(nbins, 1)                       # every group owns >= 1 partition
        load = np.zeros(nbins)
        for nd, b in zip(leaves, assign):
            pid = next_pid + (int(b) if b >= 0 else 0)
            part_of_leaf[nd.nid] = pid
            load[int(b) if b >= 0 else 0] += nd.size
        group_default[g] = next_pid + int(np.argmin(load))  # smallest occupancy
        next_pid += nbins

    # -- node -> subtree partition sets (bottom-up union) ----------------
    def fill_parts(nd: _Node) -> List[int]:
        if not nd.children:
            nd.part_set = [part_of_leaf[nd.nid]]
        else:
            acc = set()
            for p in sorted(nd.children):
                acc.update(fill_parts(nd.children[p]))
            nd.part_set = sorted(acc)
        return nd.part_set

    for g, root in enumerate(roots):
        fill_parts(root)
        # ensure the group's default partition is reachable from every node
        for nd_id in range(group_root[g],
                           group_root[g + 1] if g + 1 < num_groups else n_nodes):
            ps = nodes[nd_id].part_set
            if int(group_default[g]) not in ps:
                nodes[nd_id].part_set = sorted(ps + [int(group_default[g])])

    part_start = np.zeros(n_nodes + 1, dtype=np.int32)
    part_ids: List[int] = []
    for nd in nodes:
        part_start[nd.nid + 1] = len(nd.part_set)
        part_ids.extend(nd.part_set)
    part_start = np.cumsum(part_start).astype(np.int32)
    part_ids_a = np.asarray(part_ids, dtype=np.int32)
    max_ppn = int(np.max(np.diff(part_start))) if n_nodes else 1

    return TrieForest(
        child_start=child_start,
        edge_pivot=edge_pivot_a,
        edge_child=edge_child_a,
        edge_key=edge_key,
        node_size=node_size,
        node_depth=node_depth,
        dfs_in=dfs_in,
        dfs_out=dfs_out,
        part_start=part_start,
        part_ids=part_ids_a,
        group_root=group_root,
        group_default_part=group_default,
        num_partitions=next_pid,
        num_pivots=num_pivots,
        max_parts_per_node=max_ppn,
    )
