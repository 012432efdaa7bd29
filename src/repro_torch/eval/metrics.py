"""Recall / ranking metrics for approximate-kNN evaluation.

A copy of ``repro.eval.metrics`` (pure numpy).  Ties at the k-th distance
boundary are not scored as misses (any record at the boundary distance is
as correct as the one the oracle happened to return), and pad rows
(``gid = -1`` / :data:`repro_torch.core.refine.PAD_DIST`) are excluded on
both sides.  Inputs are ``(dist, gid)`` answer arrays — ``[Q, k]``
ascending distance, ``-1``-padded ids; tensors are brought to the host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["recall_at_k", "mean_average_precision", "frontier_auc"]


def _host(a) -> Optional[np.ndarray]:
    """A numpy view of an array or a (possibly CUDA) tensor."""
    if a is None:
        return None
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _valid(ids: np.ndarray) -> np.ndarray:
    return ids[ids >= 0]


def recall_at_k(approx_ids, exact_ids, k: Optional[int] = None, *,
                approx_dist=None, exact_dist=None,
                tie_tol: float = 1e-5) -> float:
    """Mean fraction of the true k nearest neighbours returned.

    Args:
      approx_ids / exact_ids: ``[Q, >=k]`` id arrays; ``-1`` marks pad
        slots and is excluded on both sides.
      k: evaluate the first ``k`` columns (default: exact answer width).
      approx_dist / exact_dist: when both are given, an approximate id not
        in the exact set still counts as a hit if its distance is within
        ``tie_tol`` of the k-th exact distance.

    Returns the mean over queries with a non-empty exact answer (1.0 when
    no query has one).
    """
    approx_ids, exact_ids = _host(approx_ids), _host(exact_ids)
    approx_dist, exact_dist = _host(approx_dist), _host(exact_dist)
    k = k or exact_ids.shape[1]
    per_query = []
    for i in range(len(exact_ids)):
        truth = _valid(exact_ids[i, :k])
        if truth.size == 0:
            continue
        got = _valid(approx_ids[i, :k])
        hits = np.isin(got, truth).sum()
        if approx_dist is not None and exact_dist is not None:
            boundary = exact_dist[i, :k][exact_ids[i, :k] >= 0].max()
            tied = (~np.isin(got, truth)) \
                & (approx_dist[i, :k][approx_ids[i, :k] >= 0]
                   <= boundary + tie_tol)
            hits = min(int(hits + tied.sum()), truth.size)
        per_query.append(hits / truth.size)
    return float(np.mean(per_query)) if per_query else 1.0


def mean_average_precision(approx_ids, exact_ids,
                           k: Optional[int] = None) -> float:
    """MAP@k: for each approximate rank holding a true neighbour, the
    precision of the prefix up to it, averaged over the true neighbours.
    Pad slots (``id < 0``) are skipped without occupying a rank."""
    approx_ids, exact_ids = _host(approx_ids), _host(exact_ids)
    k = k or exact_ids.shape[1]
    per_query = []
    for i in range(len(exact_ids)):
        truth = set(int(x) for x in _valid(exact_ids[i, :k]))
        if not truth:
            continue
        hits, precisions, rank = 0, [], 0
        for g in approx_ids[i, :k]:
            if g < 0:
                continue
            rank += 1
            if int(g) in truth:
                hits += 1
                precisions.append(hits / rank)
        per_query.append(sum(precisions) / len(truth))
    return float(np.mean(per_query)) if per_query else 1.0


def frontier_auc(points: Sequence[Tuple[float, float]]) -> float:
    """Area under a (cost, recall) frontier, normalised to [0, 1].

    ``points`` are ``(fraction_of_data_scanned, recall)`` pairs (any order;
    deduplicated on cost by best recall).  The step curve starts at
    ``(min_cost, its recall)`` and extends flat to cost 1.0, so the area
    rewards high recall at low cost.  Empty input yields 0.
    """
    if not points:
        return 0.0
    best = {}
    for c, r in points:
        c = float(min(max(c, 0.0), 1.0))
        best[c] = max(best.get(c, 0.0), float(r))
    xs = sorted(best)
    auc, prev_x = 0.0, xs[0]
    for i, x in enumerate(xs[1:], 1):
        auc += best[xs[i - 1]] * (x - prev_x)
        prev_x = x
    auc += best[xs[-1]] * (1.0 - prev_x)
    span = 1.0 - xs[0]
    return auc / span if span > 0 else best[xs[-1]]
