"""Fused pivot distances + top-m prefix (the P4→ signature): CUDA kernel
and plain version.

Replaces ``repro/kernels/pivot_rank.py::pivot_rank``.  Bound by fp32
operations: (2w + 3)·r FLOPs per row against 67 TFLOP/s of non-tensor
fp32, 0.438 ms at [2^22, 16] × [200, 16] on an H100.  The first kernel (one
thread per row, an insertion into a sorted m-list at every pivot that beat
the row's m-th distance) took 13.75–13.86 ms there: the insertion diverged
across the warp.  The kernel now is ``csrc/pivot_rank.cu``
(1.72 ms there): a group of lanes per row (the kernel picks it from the
batch so that the grid fills the card: 1 for the build's chunks, with two
rows per lane, and 32 for a query batch), each lane keeping its own top-m
list of a length fixed at compile time (exact for w = 16, m = 10, the
configuration's); the distances of 16 pivots at a time are staged in
shared memory, the ones that pass a branch-free filter merge only while a
warp vote says some lane has one, and the group's lists merge by shuffle
argmin on (distance, id).  fp32 FMA, no TF32; ties go to the lower pivot
id, as ``jax.lax.top_k`` gives.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

KERNEL_WIDTHS = (4, 8, 16, 32, 64)
KERNEL_MAX_M = 32


def pivot_distances_plain(paa: torch.Tensor, pivots: torch.Tensor) -> torch.Tensor:
    """``[..., r]`` squared distances max(|x|² − 2x·p + |p|², 0) from
    ``[..., w]`` rows to ``[r, w]`` pivots, fp32."""
    paa = paa.float()
    pivots = pivots.float()
    a2 = (paa * paa).sum(dim=-1, keepdim=True)
    b2 = (pivots * pivots).sum(dim=-1)
    return torch.clamp(a2 - 2.0 * (paa @ pivots.T) + b2, min=0.0)


def pivot_rank_plain(paa: torch.Tensor, pivots: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch P4→: ``[..., w]`` × ``[r, w]`` → ``[..., m]`` int32,
    nearest first.  ``jax.lax.top_k`` breaks ties toward the lower id and
    ``torch.topk`` promises no order, so the m nearest come from a stable
    sort."""
    d = pivot_distances_plain(paa, pivots)
    return torch.sort(d, dim=-1, stable=True).indices[..., :m].to(torch.int32)


def pivot_rank_work(b: int, w: int, r: int, m: int) -> _lib.Work:
    """One call's work: the rows and pivots read, the ids written, and
    2w + 3 operations per (row, pivot) distance."""
    return _lib.Work(flops=b * r * (2 * w + 3), nbytes=4 * (b * w + r * w + b * m))


def pivot_rank(paa: torch.Tensor, pivots: torch.Tensor, m: int) -> torch.Tensor:
    """P4→ through the kernel for CUDA tensors, the plain version for CPU
    tensors, the kernel's output and counted work for ``meta`` tensors.
    ``[B, w]`` × ``[r, w]`` → ``[B, m]`` int32."""
    if paa.dim() != 2 or pivots.dim() != 2 or paa.shape[1] != pivots.shape[1]:
        raise ValueError(f"pivot_rank expects [B, w] x [r, w], got "
                         f"{tuple(paa.shape)} x {tuple(pivots.shape)}")
    b, w = paa.shape
    r = pivots.shape[0]
    if m > r:
        raise ValueError(f"prefix m={m} exceeds r={r}")
    if not _lib.on_card(paa, pivots):
        return pivot_rank_plain(paa, pivots, m)
    _lib.require(paa, "pivot_rank paa", torch.float32, 2)
    _lib.require(pivots, "pivot_rank pivots", torch.float32, 2)
    if paa.device.type == "meta":
        if w not in KERNEL_WIDTHS or m > KERNEL_MAX_M:
            raise ValueError(f"pivot_rank kernel takes w in {KERNEL_WIDTHS} and "
                             f"m <= {KERNEL_MAX_M}; got w={w}, m={m}")
        return _lib.meta_outputs(pivot_rank_work(b, w, r, m), ((b, m), torch.int32))
    lib = _lib.library()
    if w not in KERNEL_WIDTHS or m > KERNEL_MAX_M \
            or lib.climber_pivot_rank_smem(w, r, m) > _lib.SMEM_LIMIT:
        raise ValueError(f"pivot_rank kernel takes w in {KERNEL_WIDTHS}, "
                         f"m <= {KERNEL_MAX_M} and pivots that fit in shared "
                         f"memory; got w={w}, m={m}, r={r}")
    out = torch.empty((b, m), dtype=torch.int32, device=paa.device)
    with torch.cuda.device(paa.device):
        _lib.check(lib.climber_pivot_rank(paa.data_ptr(), pivots.data_ptr(),
                                          out.data_ptr(), b, w, r, m, 0,
                                          _lib.stream(paa.device)),
                   "pivot_rank")
    _lib.count_launch(pivot_rank)
    return out


pivot_rank.launches = 0
