"""Public wrappers around the CUDA kernels (``repro.kernels.ops``'s
counterpart).

Each wrapper dispatches on its tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors take the kernel's plain PyTorch version.
Every kernel wrapper counts its launches in a ``launches`` attribute, so a
run can show which kernels its path went through.  The ``l2`` kernels
(``pairwise_l2``, ``qdots``) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.paa_kernel import paa
from repro_torch.kernels.pivot_rank import pivot_rank
from repro_torch.kernels.refine_topk import refine_topk

# the plan must be sorted by partition id (see kernels/refine_topk.py)
fused_refine_topk = refine_topk

KERNELS = {"paa": paa, "pivot_rank": pivot_rank, "refine_topk": refine_topk}

__all__ = ["paa", "pivot_rank", "fused_refine_topk",
           "fused_refine_topk_device_plan", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def fused_refine_topk_device_plan(data, norms, rec_dfs, rec_gid, queries,
                                  sel_part, sel_lo, sel_hi, k: int, **kw):
    """:func:`fused_refine_topk` over a plan not yet sorted by partition.

    The stable sort (pads first, ties by entry slot) happens here, on the
    plan's device; with an already-sorted plan it is the identity.
    """
    order = torch.argsort(sel_part, dim=-1, stable=True)
    take = lambda t: torch.gather(t, 1, order).to(torch.int32).contiguous()
    return refine_topk(data, norms, rec_dfs, rec_gid, queries.contiguous(),
                       take(sel_part), take(sel_lo), take(sel_hi), k, **kw)
