"""Public wrappers around the CUDA kernels (``repro.kernels.ops``'s
counterpart).

Each wrapper dispatches on its tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors take the kernel's plain PyTorch version.
Every kernel wrapper counts its launches in a ``launches`` attribute, so a
run can show which kernels its path went through.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.l2 import pairwise_l2, qdots
from repro_torch.kernels.paa_kernel import paa
from repro_torch.kernels.pivot_rank import pivot_rank
from repro_torch.kernels.refine_topk import refine_topk

# the plan must be sorted by partition id (see kernels/refine_topk.py)
fused_refine_topk = refine_topk

KERNELS = {"paa": paa, "pivot_rank": pivot_rank, "refine_topk": refine_topk,
           "pairwise_l2": pairwise_l2, "qdots": qdots}

__all__ = ["paa", "pivot_rank", "pairwise_l2", "qdots", "batched_query_dots",
           "fused_refine_topk", "fused_refine_topk_device_plan",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def batched_query_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-entry candidate dots: rows ``[Q, MP, cap, n]`` → ``[Q, MP, cap]``,
    through :func:`qdots` (the dense refine's dot product)."""
    qn, mp, cap, n = rows.shape
    return qdots(q, rows.reshape(qn, mp * cap, n)).reshape(qn, mp, cap)


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
