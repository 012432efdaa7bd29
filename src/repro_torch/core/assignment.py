"""Group assignment rules — paper Algorithm 1 (§IV-C), vectorised.

Decision ladder for each object X:
  1. all OD distances == m (no pivot overlap with any centroid)  → group 0;
  2. unique smallest OD                                          → that group;
  3. tie → smallest WD (Def. 11) among the OD-tied centroids     → that group;
  4. second tie → the lowest group id (deterministic), or, with
     ``tie_noise``, the paper's random pick among the tied groups.

OD and WD against all centroids are two fp32 matmuls (TF32 stays off, see
``repro_torch/__init__.py``).  The random second-tie break takes an
``[N, G]`` Gumbel tensor (the reference draws
``jax.random.gumbel(tie_key, (N, G))``; the parity tests hand that draw
over) and picks the argmax of the noise over the tie set.  The index build
uses the deterministic rule, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import distances as D
from repro_torch.core import signatures as S

_BIG = 1e9


def _od_wd(p4_rank: torch.Tensor, centroid_onehot: torch.Tensor,
           num_pivots: int, decay: str, decay_lambda: float):
    """(od, wd) ``[N, G]`` with the fall-back column 0 set to ``_BIG``."""
    m = p4_rank.shape[-1]
    x_oh = S.set_onehot(p4_rank, num_pivots)
    od = D.overlap_distance(x_oh, centroid_onehot, m)
    w = S.decay_weights(m, decay, decay_lambda, device=p4_rank.device)
    x_w = S.weighted_onehot(p4_rank, num_pivots, w)
    wd = D.weight_distance(x_w, centroid_onehot, D.total_weight(w))
    od[:, 0] = _BIG
    wd[:, 0] = _BIG
    return od, wd


def assign_groups(p4_rank: torch.Tensor, centroid_onehot: torch.Tensor,
                  num_pivots: int, *, decay: str = "exp",
                  decay_lambda: float = 0.5, tie_noise=None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[N]`` int32 group ids in [0, G) for ``[N, m]`` rank signatures.

    ``tie_noise``: ``[N, G]`` Gumbel noise for the random second-tie break,
    or ``True`` to draw it from ``generator``; None keeps the lowest tied
    group id.
    """
    m = p4_rank.shape[-1]
    od_real, wd = _od_wd(p4_rank, centroid_onehot, num_pivots, decay,
                         decay_lambda)
    min_od = od_real.min(dim=-1, keepdim=True).values            # [N, 1]
    no_overlap = min_od[:, 0] >= m                               # → group 0
    tie = od_real <= min_od + 0.5                                # OD is integral
    wd_masked = torch.where(tie, wd, torch.full_like(wd, _BIG))
    min_wd = wd_masked.min(dim=-1, keepdim=True).values
    tie2 = wd_masked <= min_wd + 1e-6                            # [N, G]
    if tie_noise is None:
        # lowest group id among the final tie set (argmax returns the first
        # max; it refuses bool input, hence the cast)
        group = torch.argmax(tie2.to(torch.int32), dim=-1)
    else:
        if tie_noise is True:
            u = torch.rand(tie2.shape, generator=generator, device=(
                tie2.device if generator is None else generator.device))
            tie_noise = -torch.log(-torch.log(u.clamp_min(1e-20)))
        noise = torch.as_tensor(tie_noise, dtype=torch.float32).to(tie2.device)
        if noise.shape != tie2.shape:
            raise ValueError(f"tie_noise has shape {tuple(noise.shape)}, "
                             f"expected {tuple(tie2.shape)}")
        group = torch.argmax(torch.where(tie2, noise,
                                         torch.full_like(noise, -_BIG)), dim=-1)
    return torch.where(no_overlap, 0, group).to(torch.int32)


def assignment_distances(p4_rank: torch.Tensor, centroid_onehot: torch.Tensor,
                         num_pivots: int, *, decay: str = "exp",
                         decay_lambda: float = 0.5):
    """(od, wd) against all centroids, fall-back column 0 at ``_BIG`` —
    used by the query planner.  ``[N, G]`` each."""
    return _od_wd(p4_rank, centroid_onehot, num_pivots, decay, decay_lambda)
