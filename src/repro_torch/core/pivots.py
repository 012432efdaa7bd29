"""Pivot selection — paper §V Step 1.

The paper selects pivots at random from the PAA'd sample.  ``jax.random``
draws cannot be reproduced in torch, so selection is by index: the caller
may hand over the indices (the parity tests replay the reference's draw),
and otherwise they come from a ``torch.Generator``.  The reference's
farthest-point (``maxmin``) option is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def draw_indices(n: int, size: int, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """``size`` distinct indices in ``[0, n)``, uniformly without replacement."""
    if size > n:
        raise ValueError(f"cannot draw {size} distinct indices from {n}")
    return torch.randperm(n, generator=generator, device=device)[:size]


def as_index(idx, device: torch.device) -> torch.Tensor:
    """Indices from a tensor, an array or a list as an int64 tensor."""
    if torch.is_tensor(idx):
        return idx.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.array(idx, dtype=np.int64)).to(device)


def select_pivots(paa_data: torch.Tensor, r: int, *,
                  idx: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[r, w]`` pivots: the rows ``idx`` of ``paa_data`` (drawn if None)."""
    n = paa_data.shape[0]
    if r > n:
        raise ValueError(f"cannot select r={r} pivots from {n} samples")
    if idx is None:
        idx = draw_indices(n, r, generator, paa_data.device)
    idx = as_index(idx, paa_data.device)
    if idx.shape != (r,):
        raise ValueError(f"pivot indices have shape {tuple(idx.shape)}, "
                         f"expected ({r},)")
    return paa_data[idx]
