"""Dss — Distributed Sequential Scan (paper §VII-A baseline).

The vanilla full-scan solution: compare every query with every record and
take the exact top-k.  It produces the ground truth (recall = 1.0) behind
every recall number.  The ``[Q, C]`` squared distances of each chunk come
from ``ops.pairwise_l2`` (the ``pairwise_l2`` kernel on the card, its plain
version on the CPU).  The mesh version of the JAX package
(``exact_knn_sharded``) waits for the multi-GPU slice.

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
        d2 = ops.pairwise_l2(queries, data.float().contiguous())
        ids = torch.arange(n_rec, dtype=torch.int32, device=dev).expand(qn, -1)
        best_d, best_i = topk_flat(d2, ids, k)
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
