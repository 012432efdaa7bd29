"""How ``correct`` is decided: the program's answers against the plain
reference's, for a sample of the window's queries drawn from the seed.

Two numbers are compared, each with the limit in the cell's check file
(``checks/<workload>.json``, set from the readings ``PERF.md`` lists):

* ``miss_share``: over the sampled queries, the reference's top-K records
  that the program's answer lacks, plus the program's answers that are no
  candidate of the reference's plan or repeat a record, over the
  reference's answers.  A reference record counts only where its exact d²
  lies below the reference's K-th by more than ``tie_rel`` of
  ``|q|² + |x|²``: closer than that, float32 may rank it either way.  It
  covers featurize and plan (a wrong signature or plan reads other
  partitions) and refine's selection.
* ``d2_err``: the largest gap between the program's squared distance and
  the exact one of the record it names, over ``|q|² + |x|²``: refine's
  arithmetic, and an answer that names the wrong record.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from climbench.reference.refine import Candidates


def judge(dist: np.ndarray, gid: np.ndarray, queries: torch.Tensor,
          pools: List[Candidates], data: torch.Tensor, k: int,
          tie_rel: float) -> Dict[str, float]:
    """``dist``/``gid``: the program's ``[S, k]`` answers of the sampled
    ``queries`` (``[S, n]`` on the device); ``pools``: the reference's
    candidates of each."""
    dev = queries.device
    missed = 0
    wanted = 0
    worst = 0.0
    for i, pool in enumerate(pools):
        q = queries[i].double()
        q2 = float((q * q).sum())
        g = torch.as_tensor(gid[i].astype(np.int64), device=dev)
        d = torch.as_tensor(dist[i].astype(np.float64), device=dev)
        real = g >= 0
        g, d = g[real], d[real]

        order = torch.sort(pool.d2, stable=True).indices[:k]
        ref_gid, ref_d2 = pool.gid[order], pool.d2[order]
        wanted += ref_gid.numel()
        x2 = (data[ref_gid].double() ** 2).sum(dim=-1)
        kth = float(ref_d2[-1]) if ref_gid.numel() == k else float("inf")
        required = ref_d2 < kth - tie_rel * (q2 + x2)
        missed += int((required & ~torch.isin(ref_gid, g)).sum())
        missed += int((~torch.isin(g, pool.gid)).sum())
        missed += g.numel() - int(torch.unique(g).numel())

        if g.numel():
            x = data[g].double()
            true_d2 = ((x - q[None, :]) ** 2).sum(dim=-1)
            scale = q2 + (x * x).sum(dim=-1)
            worst = max(worst, float(((d * d - true_d2).abs() / scale).max()))
    return {"miss_share": missed / max(wanted, 1), "d2_err": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limit for name, limit in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {name} {numbers[name]!r} limit {limits[name]!r}"
            for name in limits]
