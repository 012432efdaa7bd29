"""DPiSAX-like baseline (Yagoubi et al. [65]) — partitioned iSAX.

DPiSAX computes iSAX words and derives a partitioning table by recursively
splitting dense regions of the word space on the next iSAX bit until every
partition respects the capacity; every record is routed to exactly one
partition, and a query scans the single partition its own word maps to.
Partitions are leaves of a binary prefix tree over the words' bits
(segment-major, most-significant bit first).  The table and the routing are
host numpy, copied from ``repro.baselines.dpisax``; the words, the store
and the query's refine run on the index's device (the ``paa`` and
``refine_topk`` kernels on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.baselines.isax import sax_word
from repro_torch.core.index import PartitionStore, build_store, store_from_arrays
from repro_torch.core.refine import refine
from repro_torch.utils.device import DeviceLike, resolve_device


@dataclass
class DPiSAXIndex:
    segments: int
    cardinality: int
    table: Dict[Tuple[int, ...], int]   # bit-prefix → partition id (leaves)
    store: PartitionStore

    @property
    def num_partitions(self) -> int:
        return self.store.num_partitions


def _word_bits(word: np.ndarray, cardinality: int) -> np.ndarray:
    """Flatten iSAX words to their split-order bit matrix ``[..., D]``.

    Bit d compares segment ``d % segments`` at depth ``d // segments`` —
    round-robin over segments, most-significant bit first.
    """
    w = np.asarray(word)
    full_bits = int(cardinality).bit_length() - 1
    cols = [(w >> (full_bits - 1 - depth)) & 1 for depth in range(full_bits)]
    return np.concatenate(cols, axis=-1).astype(np.int8)


def _build_table(bits: np.ndarray, capacity: int
                 ) -> Tuple[Dict[Tuple[int, ...], int], np.ndarray]:
    """Adaptive partitioning table: split any over-capacity region further.
    Returns the leaf table (prefix → pid) and each record's pid."""
    n, max_depth = bits.shape
    table: Dict[Tuple[int, ...], int] = {}
    part = np.zeros(n, dtype=np.int32)
    stack = [(np.arange(n), 0, ())]
    while stack:
        rows, depth, prefix = stack.pop()
        if len(rows) <= capacity or depth >= max_depth:
            pid = len(table)
            table[prefix] = pid
            part[rows] = pid
            continue
        b = bits[rows, depth]
        stack.append((rows[b == 0], depth + 1, prefix + (0,)))
        stack.append((rows[b == 1], depth + 1, prefix + (1,)))
    return table, part


def _route(table: Dict[Tuple[int, ...], int], bits: np.ndarray) -> np.ndarray:
    """Longest-prefix descent of each word through the leaf table."""
    out = np.empty(bits.shape[0], dtype=np.int32)
    for i, row in enumerate(bits):
        prefix: Tuple[int, ...] = ()
        while prefix not in table:
            prefix = prefix + (int(row[len(prefix)]),)
        out[i] = table[prefix]
    return out


def build_dpisax(data: torch.Tensor, *, segments: int = 16,
                 cardinality: int = 8, capacity: int = 3000,
                 device: DeviceLike = None) -> DPiSAXIndex:
    """Build the partitioning table and the store on ``device`` (the card
    unless the caller names another).  A leaf at full word depth can exceed
    ``capacity``, and the padded store then pads every partition to it."""
    dev = resolve_device(device)
    data = torch.as_tensor(data).to(dev, torch.float32)
    n_rec = data.shape[0]
    word = sax_word(data, segments, cardinality).cpu().numpy()
    table, part = _build_table(_word_bits(word, cardinality), capacity)
    rec_dfs = torch.zeros(n_rec, dtype=torch.int32)   # one node per partition
    store = build_store(data, torch.from_numpy(part), rec_dfs, len(table))
    return DPiSAXIndex(segments=segments, cardinality=cardinality,
                       table=table, store=store)


def dpisax_from_arrays(table: Mapping[Tuple[int, ...], int],
                       arrays: Mapping[str, np.ndarray], *, segments: int = 16,
                       cardinality: int = 8,
                       device: DeviceLike = None) -> DPiSAXIndex:
    """Carry a JAX-package DPiSAX index across: its table and its store laid
    out as ``store_<field>`` arrays (``repro.distributed.store.store_to_arrays``)."""
    return DPiSAXIndex(segments=segments, cardinality=cardinality,
                       table=dict(table),
                       store=store_from_arrays(arrays, resolve_device(device)))


def dpisax_knn(index: DPiSAXIndex, queries: torch.Tensor, k: int, *,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-partition approximate kNN (the DPiSAX query model).
    ``use_kernel=False`` takes the dense refine (see ``core/refine.py``)."""
    dev = index.store.data.device
    queries = torch.as_tensor(queries).to(dev, torch.float32)
    word = sax_word(queries, index.segments, index.cardinality).cpu().numpy()
    part = _route(index.table, _word_bits(word, index.cardinality))
    q = queries.shape[0]
    sel_part = torch.from_numpy(part).to(dev)[:, None]              # [Q, 1]
    sel_lo = torch.zeros((q, 1), dtype=torch.int32, device=dev)
    sel_hi = torch.ones((q, 1), dtype=torch.int32, device=dev)
    return refine(index.store, queries, sel_part, sel_lo, sel_hi, k,
                  use_kernel=use_kernel)
