"""The CLIMBER index built again, in plain PyTorch, from the collection and
the run's two draws (paper §V, Fig. 6): the sample's PAA and pivots, the
skeleton (``skeleton.py``), then every record's signature, group
(Algorithm 1), trie leaf and partition, and the store's ``[P, cap]`` tags,
ids and norms.

The device steps are plain PyTorch copies of the program's (one-hot OD/WD
matmuls of small integers and powers of two, exact in float32;
``searchsorted`` descent; a stable sort of records by partition), so given
the same signatures they give the same index.  ``precision`` is passed to
the featurize step only (see ``featurize.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from climbench.reference import featurize as F
from climbench.reference.skeleton import TrieForest, build_forest, compute_centroids

_BIG = 1e9
ROUTE_CHUNK = 1 << 18


class Trie(NamedTuple):
    """The skeleton's tables on the device."""

    edge_key: torch.Tensor
    edge_child: torch.Tensor
    has_children: torch.Tensor
    node_size: torch.Tensor
    dfs_in: torch.Tensor
    dfs_out: torch.Tensor
    part_ids_pad: torch.Tensor      # [nodes, maxP], -1 padded
    group_root: torch.Tensor
    group_default_part: torch.Tensor
    num_pivots: int

    @classmethod
    def from_forest(cls, f: TrieForest, device) -> "Trie":
        n = f.num_nodes
        maxp = max(f.max_parts_per_node, 1)
        counts = np.diff(f.part_start)
        pad = np.full((n, maxp), -1, dtype=np.int32)
        col = np.arange(len(f.part_ids)) - np.repeat(f.part_start[:-1], counts)
        pad[np.repeat(np.arange(n), counts), col] = f.part_ids
        t = lambda a, dt=None: torch.as_tensor(
            np.ascontiguousarray(a if dt is None else a.astype(dt)), device=device)
        return cls(edge_key=t(f.edge_key, np.int32),
                   edge_child=t(f.edge_child, np.int32),
                   has_children=t(np.diff(f.child_start) > 0),
                   node_size=t(f.node_size, np.float32),
                   dfs_in=t(f.dfs_in, np.int32), dfs_out=t(f.dfs_out, np.int32),
                   part_ids_pad=t(pad), group_root=t(f.group_root, np.int32),
                   group_default_part=t(f.group_default_part, np.int32),
                   num_pivots=int(f.num_pivots))


class Store(NamedTuple):
    norms: torch.Tensor     # [P, cap] |x|², float64 summed, float32 kept
    rec_dfs: torch.Tensor   # [P, cap]
    rec_gid: torch.Tensor   # [P, cap], -1 = empty slot
    count: torch.Tensor     # [P]


class Index(NamedTuple):
    cfg: dict
    pivots: torch.Tensor
    centroid_onehot: torch.Tensor
    trie: Trie
    store: Store
    num_partitions: int


def _scatter_rows(p4, r, values):
    out = torch.zeros(*p4.shape[:-1], r, dtype=values.dtype, device=p4.device)
    return out.scatter_add_(-1, p4.long(), values)


def od_wd(p4_rank, centroid_onehot, cfg):
    """(OD, WD) ``[N, G]`` (Defs. 7, 11), the fall-back column 0 at _BIG."""
    m = p4_rank.shape[-1]
    r = cfg["num_pivots"]
    x_oh = _scatter_rows(p4_rank, r, torch.ones(p4_rank.shape, dtype=torch.float32,
                                                device=p4_rank.device))
    od = m - x_oh @ centroid_onehot.T
    i = torch.arange(1, m + 1, dtype=torch.float32, device=p4_rank.device)
    if cfg["decay"] == "exp":
        w = cfg["decay_lambda"] ** (i - 1.0)
    else:
        w = (m - i + 1.0) / m
    x_w = _scatter_rows(p4_rank, r, w.expand(p4_rank.shape).contiguous())
    wd = w.sum() - x_w @ centroid_onehot.T
    od[:, 0] = _BIG
    wd[:, 0] = _BIG
    return od, wd


def assign_groups(p4_rank, centroid_onehot, cfg):
    """Algorithm 1 with the lowest-id second tie-break: ``[N]`` int32."""
    m = p4_rank.shape[-1]
    od, wd = od_wd(p4_rank, centroid_onehot, cfg)
    min_od = od.min(dim=-1, keepdim=True).values
    no_overlap = min_od[:, 0] >= m
    tie = od <= min_od + 0.5
    wd_masked = torch.where(tie, wd, torch.full_like(wd, _BIG))
    min_wd = wd_masked.min(dim=-1, keepdim=True).values
    tie2 = wd_masked <= min_wd + 1e-6
    group = torch.argmax(tie2.to(torch.int32), dim=-1)
    return torch.where(no_overlap, 0, group).to(torch.int32)


def descend(trie: Trie, p4_rank, group):
    """(landing node, matched prefix length, parent) down each group's trie."""
    m = p4_rank.shape[-1]
    e = trie.edge_key.shape[0]
    node = trie.group_root[group.long()]
    parent = node
    pathlen = torch.zeros(node.shape, dtype=torch.int32, device=node.device)
    if e == 0:
        return node, pathlen, parent
    alive = torch.ones(node.shape, dtype=torch.bool, device=node.device)
    for d in range(m):
        key = node * trie.num_pivots + p4_rank[..., d].to(torch.int32)
        pos = torch.searchsorted(trie.edge_key, key)
        pos_c = torch.clamp(pos, max=e - 1)
        found = alive & (trie.edge_key[pos_c] == key) & (pos < e)
        parent = torch.where(found, node, parent)
        node = torch.where(found, trie.edge_child[pos_c], node)
        pathlen = pathlen + found.to(torch.int32)
        alive = found
    return node, pathlen, parent


def route(trie: Trie, p4_rank, group):
    """A record's partition (its leaf's own, else its group's default) and
    its DFS tag (§V Step 4)."""
    node, _, _ = descend(trie, p4_rank, group)
    nl = node.long()
    is_leaf = ~trie.has_children[nl]
    leaf_part = trie.part_ids_pad[nl, 0]
    if trie.part_ids_pad.shape[1] > 1:
        second = trie.part_ids_pad[nl, 1]
    else:
        second = torch.full_like(leaf_part, -1)
    default = trie.group_default_part[group.long()]
    own = torch.where((leaf_part == default) & (second >= 0), second, leaf_part)
    return torch.where(is_leaf, own, default).to(torch.int32), trie.dfs_in[nl]


def build_store(data, part, rec_dfs, num_partitions, chunk=ROUTE_CHUNK) -> Store:
    """Records into ``[P, cap]`` slots in dataset order per partition: their
    tags, ids and norms (the rows stay in ``data``, which the refine reads
    by id)."""
    dev = data.device
    n_rec = data.shape[0]
    part = part.long()
    counts = torch.bincount(part, minlength=num_partitions)
    cap = max(int(counts.max()), 1)
    order = torch.argsort(part, stable=True)
    part_sorted = part[order]
    starts = torch.cumsum(counts, dim=0) - counts
    slot = torch.arange(n_rec, device=dev) - starts[part_sorted]
    norms = torch.zeros((num_partitions, cap), dtype=torch.float32, device=dev)
    for lo in range(0, n_rec, chunk):
        rows = order[lo:lo + chunk]
        x = data[rows].float()
        norms[part_sorted[lo:lo + chunk], slot[lo:lo + chunk]] = \
            (x.double() ** 2).sum(dim=-1).float()
    store_dfs = torch.full((num_partitions, cap), -1, dtype=torch.int32, device=dev)
    store_gid = torch.full((num_partitions, cap), -1, dtype=torch.int32, device=dev)
    store_dfs[part_sorted, slot] = rec_dfs[order].to(torch.int32)
    store_gid[part_sorted, slot] = order.to(torch.int32)
    return Store(norms, store_dfs, store_gid, counts.to(torch.int32))


def sample_size(n_rec: int, cfg: dict) -> int:
    return int(np.clip(int(n_rec * cfg["sample_frac"]),
                       min(n_rec, max(4 * cfg["num_pivots"], 256)), n_rec))


def build(data: torch.Tensor, cfg: dict, sample_idx: torch.Tensor,
          pivot_idx: torch.Tensor, precision: str = "fp32") -> Index:
    """The index of ``data`` for the draws ``sample_idx`` ([S]) and
    ``pivot_idx`` ([r] rows of the sample)."""
    dev = data.device
    n_rec = data.shape[0]
    w, m, r = cfg["paa_segments"], cfg["prefix_len"], cfg["num_pivots"]
    s = sample_size(n_rec, cfg)
    alpha = s / n_rec
    sample_paa = F.paa(data[sample_idx.to(dev)], w)
    pivots = sample_paa[pivot_idx.to(dev)]
    p4r_s = F.rank_signature(sample_paa, pivots, m, precision)
    p4r_np = p4r_s.cpu().numpy()
    p4s_np = torch.sort(p4r_s, dim=-1).values.cpu().numpy()
    cents = compute_centroids(p4s_np, r, sample_frac=alpha,
                              capacity=cfg["capacity"],
                              min_od=cfg["centroid_min_od"],
                              max_centroids=cfg["max_centroids"])
    c_onehot = torch.as_tensor(cents.onehot, device=dev)
    uniq, counts = np.unique(p4r_np, axis=0, return_counts=True)
    grp_s = assign_groups(torch.as_tensor(uniq, device=dev), c_onehot, cfg)
    forest = build_forest(uniq, counts, grp_s.cpu().numpy(), cents.num_groups,
                          r, capacity=float(cfg["capacity"]), sample_frac=alpha)
    trie = Trie.from_forest(forest, dev)
    parts, dfs = [], []
    for lo in range(0, n_rec, ROUTE_CHUNK):
        z = F.paa(data[lo:lo + ROUTE_CHUNK], w)
        p4r = F.rank_signature(z, pivots, m, precision)
        part, rec_dfs = route(trie, p4r, assign_groups(p4r, c_onehot, cfg))
        parts.append(part)
        dfs.append(rec_dfs)
    store = build_store(data, torch.cat(parts), torch.cat(dfs),
                        forest.num_partitions)
    return Index(cfg, pivots, c_onehot, trie, store, forest.num_partitions)


def featurize(index: Index, queries: torch.Tensor, precision: str = "fp32"):
    """``[Q, m]`` rank signatures of raw ``[Q, n]`` queries."""
    z = F.paa(queries, index.cfg["paa_segments"])
    return F.rank_signature(z, index.pivots, index.cfg["prefix_len"], precision)
