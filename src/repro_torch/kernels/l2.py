"""Pairwise squared L2 and per-query candidate dots: CUDA kernels and plain
versions.

Replaces ``repro/kernels/l2.py``:

* :func:`pairwise_l2` (``pairwise_l2``): q ``[Q, n]`` × x ``[C, n]`` →
  ``[Q, C]`` squared ED, ``max(‖q‖² − 2q·x + ‖x‖², 0)`` with fp32
  accumulation — the exact scan behind every ground truth
  (``baselines/dss.py``).  Bound by fp32 operations, 2n FLOPs per output.
  The kernel is a persistent grid of one block per SM that keeps its 64
  queries in shared memory and streams 256-candidate tiles through a
  ``cp.async`` ring into 8 × 8 register tiles; each output sums its dot
  and both norms in ascending k with fmaf, so its bits depend on n alone.
* :func:`qdots` (``qdots``): q ``[Q, n]``, rows ``[Q, C, n]`` → ``[Q, C]``,
  each query against its own candidate rows — the dense refine's dot
  product (``ops.batched_query_dots``).  Bound by HBM bytes, 2 FLOPs per
  4 bytes of rows: 0.593 ms on an H100 at q ``[60, 256]``, rows
  ``[60, 32208, 256]``.  The kernel is a persistent grid of warps that each
  issue the streaming loads of 4 rows before reducing any, with the query
  row in registers for n ≤ 512 (n % 4 == 0) and a scalar-load kernel of the
  same summation order otherwise.  The first design (a block per 64 rows,
  the query row in shared memory, one row per warp at a time) took
  0.672–0.716 ms there, 3–6 % behind ``torch.bmm``.

Both kernels are ``csrc/l2.cu`` (see the source for the designs): fp32 FMA,
no TF32.  CUDA tensors launch the kernel (or raise), CPU tensors take the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

def pairwise_l2_plain(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch squared ED matrix ``[Q, C]`` (``pairwise_l2_ref``)."""
    q, x = q.float(), x.float()
    q2 = (q * q).sum(dim=-1)[:, None]
    x2 = (x * x).sum(dim=-1)[None, :]
    return torch.clamp(q2 - 2.0 * (q @ x.T) + x2, min=0.0)


def qdots_plain(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-query dots ``[Q, C]`` (``qdots_ref``).

    An elementwise product and a last-axis sum, not a batched matmul, so
    each row's dot is summed in one order whatever the batch."""
    return (rows.float() * q.float()[:, None, :]).sum(dim=-1)


def pairwise_l2_work(qn: int, cn: int, n: int) -> _lib.Work:
    """One call's work: q, x read and ``[Q, C]`` written, 2n FLOPs an output."""
    return _lib.Work(flops=2 * qn * cn * n, nbytes=4 * (cn * n + qn * n + qn * cn))


def qdots_work(qn: int, cn: int, n: int) -> _lib.Work:
    """One call's work: q and the ``[Q, C, n]`` rows read, ``[Q, C]``
    written, 2n FLOPs an output."""
    return _lib.Work(flops=2 * qn * cn * n, nbytes=4 * (qn * cn * n + qn * n + qn * cn))


def pairwise_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared ED ``[Q, C]`` through the kernel for CUDA tensors, the plain
    version for CPU tensors, the kernel's output and counted work for
    ``meta`` tensors.  ``q`` ``[Q, n]``, ``x`` ``[C, n]`` float32."""
    if not _lib.on_card(q, x):
        return pairwise_l2_plain(q, x)
    _lib.require(q, "pairwise_l2 q", torch.float32, 2)
    _lib.require(x, "pairwise_l2 x", torch.float32, 2)
    qn, n = q.shape
    cn = x.shape[0]
    if x.shape[1] != n:
        raise ValueError(f"pairwise_l2: q has n={n}, x has n={x.shape[1]}")
    if q.device.type == "meta":
        return _lib.meta_outputs(pairwise_l2_work(qn, cn, n), ((qn, cn), torch.float32))
    out = torch.empty((qn, cn), dtype=torch.float32, device=q.device)
    if qn == 0 or cn == 0:
        return out
    with torch.cuda.device(q.device):
        _lib.check(_lib.library().climber_pairwise_l2(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), qn, cn, n,
            _lib.stream(q.device)), "pairwise_l2")
    _lib.count_launch(pairwise_l2)
    return out


def qdots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-query dots ``[Q, C]`` through the kernel for CUDA tensors, the
    plain version for CPU tensors, the kernel's output and counted work for
    ``meta`` tensors.  ``q`` ``[Q, n]``, ``rows`` ``[Q, C, n]`` float32."""
    if not _lib.on_card(q, rows):
        return qdots_plain(q, rows)
    _lib.require(q, "qdots q", torch.float32, 2)
    _lib.require(rows, "qdots rows", torch.float32, 3)
    qn, n = q.shape
    if rows.shape[0] != qn or rows.shape[2] != n:
        raise ValueError(f"qdots: rows {tuple(rows.shape)} do not match "
                         f"q {tuple(q.shape)}")
    cn = rows.shape[1]
    if q.device.type == "meta":
        return _lib.meta_outputs(qdots_work(qn, cn, n), ((qn, cn), torch.float32))
    out = torch.empty((qn, cn), dtype=torch.float32, device=q.device)
    if qn == 0 or cn == 0:
        return out
    with torch.cuda.device(q.device):
        _lib.check(_lib.library().climber_qdots(
            q.data_ptr(), rows.data_ptr(), out.data_ptr(), qn, cn, n,
            _lib.stream(q.device)), "qdots")
    _lib.count_launch(qdots)
    return out


pairwise_l2.launches = 0
qdots.launches = 0
