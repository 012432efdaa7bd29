"""TARDIS-like baseline (Zhang et al. [67]) — sigTree over iSAX words.

TARDIS builds a wide n-ary tree over full iSAX words — level d branches on
segment d's symbol — splits nodes over capacity, and packs subtrees into
physical partitions; a query descends to its deepest matching node and scans
that node's partitions.  The sigTree is CLIMBER's flattened trie with
alphabet = SAX cardinality instead of pivot ids, so the only difference from
CLIMBER is the representation.

The sample is a random draw: the JAX package uses ``jax.random.choice``,
which torch cannot reproduce, so :func:`build_tardis` takes the sample
indices (a test hands over the reference's draw) or draws them from a
``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.baselines.isax import sax_word
from repro_torch.core import pivots as pivots_mod
from repro_torch.core.index import (PartitionStore, build_store,
                                    forest_from_arrays, store_from_arrays)
from repro_torch.core.refine import refine
from repro_torch.core.traversal import TrieDevice, descend, route_records
from repro_torch.core.trie import TrieForest, build_forest
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclass
class TardisIndex:
    segments: int
    cardinality: int
    forest: TrieForest
    trie: TrieDevice
    store: PartitionStore


def tardis_sample_size(n_rec: int, sample_frac: float) -> int:
    """Records in the skeleton sample (the reference's rule)."""
    return max(int(n_rec * sample_frac), min(n_rec, 256))


def build_tardis(data: torch.Tensor, *, segments: int = 16,
                 cardinality: int = 8, capacity: int = 3000,
                 sample_frac: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 sample_idx=None, device: DeviceLike = None) -> TardisIndex:
    """sigTree over the sample's unique words, then every record routed to
    its partition, on ``device`` (the card unless the caller names another).
    ``sample_idx`` (``[S]``, S = :func:`tardis_sample_size`) is the draw;
    when omitted it comes from ``generator``.  Records whose word leaves the
    tree at an internal node all go to the default partition, which the
    padded store then pads every partition to."""
    dev = resolve_device(device)
    data = torch.as_tensor(data).to(dev, torch.float32)
    n_rec = data.shape[0]
    size = tardis_sample_size(n_rec, sample_frac)
    if sample_idx is None:
        sample_idx = pivots_mod.draw_indices(n_rec, size, generator, dev)
    sample_idx = pivots_mod.as_index(sample_idx, dev)
    if sample_idx.shape != (size,):
        raise ValueError(f"sample_idx has shape {tuple(sample_idx.shape)}, "
                         f"expected ({size},)")

    words_s = sax_word(data[sample_idx], segments, cardinality).cpu().numpy()
    uniq, counts = np.unique(words_s, axis=0, return_counts=True)
    forest = build_forest(uniq.astype(np.int32), counts,
                          np.zeros(len(uniq), dtype=np.int32), 1, cardinality,
                          capacity=float(capacity), sample_frac=size / n_rec)
    trie = TrieDevice.from_forest(forest, dev)

    words = sax_word(data, segments, cardinality)
    grp = torch.zeros(n_rec, dtype=torch.int32, device=dev)
    part, rec_dfs = route_records(trie, words, grp)
    store = build_store(data, part, rec_dfs, forest.num_partitions)
    return TardisIndex(segments=segments, cardinality=cardinality,
                       forest=forest, trie=trie, store=store)


def tardis_from_arrays(arrays: Mapping[str, np.ndarray], *, segments: int = 16,
                       cardinality: int = 8,
                       device: DeviceLike = None) -> TardisIndex:
    """Carry a JAX-package TARDIS index across: ``store_<field>`` and
    ``forest_<name>`` arrays, as for :func:`repro_torch.core.index.index_from_arrays`."""
    dev = resolve_device(device)
    store = store_from_arrays(arrays, dev)
    forest = forest_from_arrays(arrays, store.num_partitions, cardinality)
    return TardisIndex(segments=segments, cardinality=cardinality,
                       forest=forest, trie=TrieDevice.from_forest(forest, dev),
                       store=store)


def tardis_knn(index: TardisIndex, queries: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deepest-node single-target query (the sigTree search model)."""
    dev = index.store.data.device
    queries = torch.as_tensor(queries).to(dev, torch.float32)
    words = sax_word(queries, index.segments, index.cardinality)
    grp = torch.zeros(queries.shape[0], dtype=torch.int32, device=dev)
    node, _, _ = descend(index.trie, words, grp)
    nl = node.long()
    sel_part = index.trie.part_ids_pad[nl]                         # [Q, maxP]
    sel_lo = index.trie.dfs_in[nl][:, None].expand_as(sel_part).contiguous()
    sel_hi = index.trie.dfs_out[nl][:, None].expand_as(sel_part).contiguous()
    return refine(index.store, queries, sel_part, sel_lo, sel_hi, k)
