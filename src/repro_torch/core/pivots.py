"""Pivot selection — paper §V Step 1.

The paper selects pivots at random from the PAA'd sample.  ``jax.random``
draws cannot be reproduced in torch, so selection is by index: the caller
may hand over the indices (the parity tests replay the reference's draw),
and otherwise they come from a ``torch.Generator``.

The reference's beyond-paper farthest-point option (``method="maxmin"``,
:func:`select_pivots_maxmin`) draws only its first index; the rest is a
deterministic greedy k-center on the sample's device.
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


def maxmin_indices(paa_data: torch.Tensor, r: int, first) -> torch.Tensor:
    """``[r]`` farthest-point indices starting at row ``first``: each next
    row maximises the squared distance to the rows chosen so far (the
    first maximum on ties, as ``jnp.argmax``).  O(r·N·w) on the data's
    device."""
    x = paa_data.float()
    first = as_index(first, x.device).reshape(())
    chosen = [first]
    d2 = ((x - x[first]) ** 2).sum(dim=-1)
    for _ in range(r - 1):
        nxt = torch.argmax(d2)
        chosen.append(nxt)
        d2 = torch.minimum(d2, ((x - x[nxt]) ** 2).sum(dim=-1))
    return torch.stack(chosen)


def select_pivots_maxmin(paa_data: torch.Tensor, r: int, *, first=None,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """``[r, w]`` farthest-point ("max-min") pivots.  Beyond-paper option.

    ``first`` is the starting row (the reference draws it with
    ``jax.random.randint(key, (), 0, n)``); None draws it from
    ``generator``.
    """
    n = paa_data.shape[0]
    if r > n:
        raise ValueError(f"cannot select r={r} pivots from {n} samples")
    if first is None:
        first = torch.randint(n, (), generator=generator, device=(
            paa_data.device if generator is None else generator.device))
    return paa_data[maxmin_indices(paa_data, r, first)]


def select_pivots(paa_data: torch.Tensor, r: int, *,
                  idx: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  method: str = "random") -> torch.Tensor:
    """``[r, w]`` pivots of ``paa_data``.

    ``method="random"``: the rows ``idx`` (``[r]``, drawn if None).
    ``method="maxmin"``: :func:`select_pivots_maxmin` from the row ``idx``
    (a single index, drawn if None).
    """
    if method == "maxmin":
        return select_pivots_maxmin(paa_data, r, first=idx, generator=generator)
    if method != "random":
        raise ValueError(f"unknown pivot selection method {method!r}")
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
