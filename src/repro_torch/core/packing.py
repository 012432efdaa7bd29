"""Node Packing (paper Def. 13) via First-Fit-Decreasing.

Packs trie leaf nodes into as few physical partitions as possible subject to
the capacity constraint c.  FFD is the paper's choice: O(m log m), 1.5-OPT
worst case [20].  Oversized leaves (possible when the trie ran out of prefix
depth) get a dedicated partition each — capacity is a soft constraint (§V).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

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
