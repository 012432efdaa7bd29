"""P⁴ dual signature generation — paper §IV-B Step 2 (Def. 5/6).

Each object receives its rank-sensitive signature P4→ (ids of its m nearest
pivots, nearest first) and its rank-insensitive signature P4⇄ (the same ids
in ascending order).  For OD/WD the set signature becomes an r-dim one-hot
row and the rank signature a weighted one-hot row (Def. 9).

``pivot_distances`` and ``rank_signature`` are the plain PyTorch versions
that live beside the pivot-rank CUDA kernel (``kernels.pivot_rank``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pivot_rank import pivot_distances_plain as pivot_distances
from repro_torch.kernels.pivot_rank import pivot_rank_plain as rank_signature


def set_signature(p4_rank: torch.Tensor) -> torch.Tensor:
    """P4⇄ (Def. 6): ascending-id ordering.  ``[..., m]``."""
    return torch.sort(p4_rank, dim=-1).values


def _scatter_rows(p4: torch.Tensor, r: int, values: torch.Tensor) -> torch.Tensor:
    """``[..., r]`` rows summing ``values[..., m]`` at the ids ``p4[..., m]``
    (the one-hot sum without its ``[..., m, r]`` intermediate)."""
    out = torch.zeros(*p4.shape[:-1], r, dtype=values.dtype, device=p4.device)
    return out.scatter_add_(-1, p4.long(), values)


def set_onehot(p4: torch.Tensor, r: int, dtype=torch.float32) -> torch.Tensor:
    """Bitset form of a signature: ``[..., r]`` with 1 at member pivot ids."""
    return _scatter_rows(p4, r, torch.ones(p4.shape, dtype=dtype,
                                           device=p4.device))


def decay_weights(m: int, kind: str = "exp", lam: float = 0.5,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Pivot weights of Def. 9 (exp: λ^(i-1); linear: (m-i+1)/m)."""
    i = torch.arange(1, m + 1, dtype=dtype, device=device)
    if kind == "exp":
        w = lam ** (i - 1.0)
    elif kind == "linear":
        w = (m - i + 1.0) / m
    else:
        raise ValueError(f"unknown decay {kind!r}")
    return w.to(dtype)


def weighted_onehot(p4_rank: torch.Tensor, r: int,
                    weights: torch.Tensor) -> torch.Tensor:
    """``[..., r]`` row with W_i at the i-th ranked pivot's id (Def. 9)."""
    return _scatter_rows(p4_rank, r, weights.expand(p4_rank.shape).contiguous())


def compute_signatures(paa: torch.Tensor, pivots: torch.Tensor, m: int):
    """Convenience: (p4_rank, p4_set) for a batch of PAA signatures."""
    p4r = rank_signature(paa, pivots, m)
    return p4r, set_signature(p4r)
