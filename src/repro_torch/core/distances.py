"""Similarity metrics of the dual representation — paper Defs. 3, 7, 9–11.

All metrics are dense linear algebra over bitset / weighted-bitset rows, so
they vectorise over millions of objects.
"""
from __future__ import annotations

import torch


def euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ED (Def. 3) between broadcast-compatible series.  ``[...]``."""
    return torch.sqrt(torch.clamp(((x - y) ** 2).sum(dim=-1), min=0.0))


def squared_l2_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared ED: x ``[Q, n]``, y ``[N, n]`` → ``[Q, N]``."""
    x2 = (x * x).sum(dim=-1)[:, None]
    y2 = (y * y).sum(dim=-1)[None, :]
    return torch.clamp(x2 - 2.0 * (x @ y.T) + y2, min=0.0)


def overlap_distance(x_onehot: torch.Tensor, c_onehot: torch.Tensor,
                     m: int) -> torch.Tensor:
    """OD (Def. 7): m − |X ∩ Y| for bitset rows ``[..., r]`` × ``[G, r]``."""
    return m - x_onehot @ c_onehot.T


def total_weight(weights: torch.Tensor) -> torch.Tensor:
    """TW (Def. 10) — constant given fixed m and decay."""
    return weights.sum()


def weight_distance(x_weighted: torch.Tensor, c_onehot: torch.Tensor,
                    tw: torch.Tensor) -> torch.Tensor:
    """WD (Def. 11): TW − Σ_i W_i·1[pivot_i ∈ centroid].  ``[..., G]``."""
    return tw - x_weighted @ c_onehot.T
