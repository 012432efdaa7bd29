"""Dss — Distributed Sequential Scan (paper §VII-A baseline).

The vanilla full-scan solution: compare every query with every record and
take the exact top-k.  It produces the ground truth (recall = 1.0) behind
every recall number.  The ``[Q, C]`` squared distances of each chunk come
from ``ops.pairwise_l2`` (the ``pairwise_l2`` kernel on the card, its plain
version on the CPU).  On a :class:`~repro_torch.launch.DeviceMesh`
(:func:`exact_knn_sharded`) the records split over the slots: each slot
scans its rows on its device and keeps a local top-k with global ids, and
one merge on the lead device takes the k best by (d², id).

The answer is the k smallest by (d², record id): ``jax.lax.top_k`` breaks
ties toward the lower index and the chunked scan keeps the running best
ahead of each new chunk, so a stable sort (``topk_flat``) reproduces it
exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.refine_topk import PAD_D2, topk_flat
from repro_torch.launch.mesh import as_mesh


def exact_knn(queries: torch.Tensor, data: torch.Tensor, k: int, *,
              chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by full scan, on the tensors' device.

    Args:
      queries: ``[Q, n]``; data: ``[N, n]``; k: answers per query.
      chunk: scan the dataset in chunks of this many rows (0 = one pass),
        keeping a running top-k — bounds the ``[Q, N]`` distance matrix.

    Returns:
      (dist, idx): ``[Q, k]`` ascending ED (float32) and record ids (int32).
    """
    queries = queries.float().contiguous()
    qn, n_rec = queries.shape[0], data.shape[0]
    dev = queries.device
    k = min(k, n_rec)
    if not chunk or chunk >= n_rec:
        best_d, best_i = _scan_d2(queries, data, k, 0)
        return torch.sqrt(torch.clamp(best_d, min=0.0)), best_i

    best_d = torch.full((qn, k), PAD_D2, dtype=torch.float32, device=dev)
    best_i = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n_rec, chunk):
        block = data[start:start + chunk].float().contiguous()
        d2 = ops.pairwise_l2(queries, block)
        ids = torch.arange(start, start + block.shape[0], dtype=torch.int32,
                           device=dev).expand(qn, -1)
        best_d, best_i = topk_flat(torch.cat([best_d, d2], dim=1),
                                   torch.cat([best_i, ids], dim=1), k)
    return torch.sqrt(torch.clamp(best_d, min=0.0)), best_i


def _scan_d2(queries: torch.Tensor, data: torch.Tensor, k: int, base: int):
    """Top-k ``(d², global id)`` of one block of rows, on its device."""
    d2 = ops.pairwise_l2(queries, data.float().contiguous())
    ids = torch.arange(base, base + data.shape[0], dtype=torch.int32,
                       device=queries.device).expand(queries.shape[0], -1)
    return topk_flat(d2, ids, k)


def exact_knn_sharded(queries: torch.Tensor, data: torch.Tensor, k: int, *,
                      mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the records split over ``mesh``'s slots.

    Slot d scans the rows ``[d·per, (d+1)·per)``, ``per = ceil(N / D)``
    (views where the slot is the data's device, a copy otherwise), through
    ``pairwise_l2`` on its device, and keeps its top-k with global ids.
    Every slot is launched before the first gather; the lists meet on the
    lead device and merge on d² in slot order, so ties fall to the lower
    id, and the square root comes last — :func:`exact_knn`'s answer.

    Returns ``(dist [Q, k], idx [Q, k])`` on the lead device.
    """
    mesh = as_mesh(mesh)
    queries = queries.float()
    n_rec = data.shape[0]
    k = min(k, n_rec)
    per = -(-n_rec // mesh.size)
    parts = []
    for d, dev in enumerate(mesh.slots):
        lo, hi = min(d * per, n_rec), min((d + 1) * per, n_rec)
        if hi == lo:
            continue
        parts.append(_scan_d2(queries.to(dev).contiguous(),
                              data[lo:hi].to(dev), min(k, hi - lo), lo))
    lead = mesh.lead
    best_d, best_i = topk_flat(torch.cat([p[0].to(lead) for p in parts], 1),
                               torch.cat([p[1].to(lead) for p in parts], 1), k)
    return torch.sqrt(torch.clamp(best_d, min=0.0)), best_i


def recall(approx_ids, exact_ids) -> float:
    """Def. 4: |S_approx ∩ S_exact| / |S_exact|, averaged over queries."""
    a = np.asarray(torch.as_tensor(approx_ids).cpu())
    e = np.asarray(torch.as_tensor(exact_ids).cpu())
    scores = []
    for i in range(a.shape[0]):
        sa = set(int(v) for v in a[i] if v >= 0)
        se = set(int(v) for v in e[i])
        scores.append(len(sa & se) / max(len(se), 1))
    return float(np.mean(scores))
