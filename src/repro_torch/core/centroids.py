"""Computation of group centroids — paper Algorithm 2 (§V Step 2).

The skeleton is built on the host from a small sample (as the paper builds
it in Spark's single coordinating process): rank-insensitive signatures are aggregated by
exact match into (signature, frequency) pairs, sorted by descending frequency,
and admitted greedily as centroids subject to
  (1) OD ≥ ε from every previously accepted centroid   (spread),
  (2) estimated group size ≥ α·c                        (no tiny groups),
  (3) an optional MaxCentroids cap.
The special fall-back centroid (G0, the empty set ``<*,*,...>``) is always
present; we place it at index 0 so that "assign to group 0" is the no-overlap
escape hatch of Algorithm 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


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
