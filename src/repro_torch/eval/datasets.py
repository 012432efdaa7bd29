"""Seeded evaluation corpora: tenant-sharded datasets + stratified queries.

* **Shards have structure.**  :func:`tenant_corpus` mixes a shard-specific
  *motif* (a smooth random series, the tenant's regime) into each shard's
  records at ``affinity`` strength, so nearest neighbours concentrate in
  the owning shard and routing has a real signal.
* **Queries are stratified by difficulty.**  :func:`hardness_split` splits
  by the ground-truth contrast ratio ``d_2k / d_k``: a low ratio means many
  near-ties just outside the answer, the queries approximate search gets
  wrong first.

The draws come from a ``torch.Generator`` seeded with the corpus seed (the
JAX package's keys cannot be reproduced); :func:`tenant_corpus` and
:func:`perturbed_queries` also take the draws as arguments, so a test hands
over the JAX package's and gets its corpus and queries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.paa import znormalize
from repro_torch.core.pivots import as_index
from repro_torch.data.series import GENERATORS
from repro_torch.utils.device import DeviceLike, resolve_device

__all__ = ["TenantCorpus", "tenant_corpus", "perturbed_queries",
           "hardness_split"]


@dataclass(frozen=True)
class TenantCorpus:
    """A sharded evaluation dataset with per-tenant structure."""

    name: str                           # base generator name
    shards: Tuple[torch.Tensor, ...]    # per-tenant [n_i, n] float32 blocks
    seed: int
    affinity: float

    @property
    def union(self) -> torch.Tensor:
        return torch.cat(self.shards, dim=0)

    def meta(self) -> Dict:
        """Identity of this corpus — keys the ground-truth cache (the same
        dict as ``repro.eval.datasets.TenantCorpus.meta``)."""
        return {"name": self.name, "seed": self.seed,
                "affinity": self.affinity,
                "shard_sizes": [int(len(s)) for s in self.shards],
                "series_len": int(self.shards[0].shape[1])}


def tenant_corpus(name: str, *, num_shards: int, shard_size: int,
                  series_len: int, seed: int = 0, affinity: float = 0.8,
                  device: DeviceLike = None,
                  bases: Optional[Sequence[torch.Tensor]] = None,
                  motif_steps: Optional[Sequence[torch.Tensor]] = None
                  ) -> TenantCorpus:
    """A per-tenant sharded corpus from base generator ``name``, on
    ``device`` (the card unless the caller names another).

    Shard i draws ``shard_size`` series from ``GENERATORS[name]`` and the
    ``[series_len]`` N(0, 1) steps of its motif (the z-normalised random
    walk that is the tenant's regime); ``bases`` / ``motif_steps`` replace
    those draws.  Rows are ``znormalize((1 − a)·base + a·motif)``: 0 = iid
    slicing, 1 = pure motif.
    """
    if name not in GENERATORS:
        raise KeyError(f"unknown generator {name!r}; "
                       f"have {sorted(GENERATORS)}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shards = []
    for i in range(num_shards):
        if bases is None:
            base = GENERATORS[name](shard_size, series_len, generator=gen)
        else:
            base = torch.as_tensor(bases[i]).to(dev, torch.float32)
        if motif_steps is None:
            steps = torch.randn((series_len,), generator=gen,
                                dtype=torch.float32, device=dev)
        else:
            steps = torch.as_tensor(motif_steps[i]).to(dev, torch.float32)
        motif = znormalize(torch.cumsum(steps, dim=-1)[None, :])
        shards.append(znormalize((1.0 - affinity) * base + affinity * motif))
    return TenantCorpus(name=name, shards=tuple(shards), seed=seed,
                        affinity=affinity)


def perturbed_queries(corpus: TenantCorpus, num_queries: int, *,
                      noise: float = 0.05, seed: int = 0, idx=None,
                      jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Queries near — not identical to — corpus rows: ``num_queries``
    distinct rows of the union plus ``noise`` × N(0, 1) jitter,
    re-z-normalised.  ``idx`` / ``jitter`` replace the draws."""
    union = corpus.union
    dev = union.device
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    if idx is None:
        idx = torch.randperm(union.shape[0], generator=gen, device=dev)[:num_queries]
    if jitter is None:
        jitter = torch.randn((num_queries, union.shape[1]), generator=gen,
                             dtype=torch.float32, device=dev)
    jitter = torch.as_tensor(jitter).to(dev, torch.float32)
    return znormalize(union[as_index(idx, dev)] + noise * jitter)


def hardness_split(exact_dist, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split query indices into (hard, easy) halves by answer contrast.

    ``exact_dist`` is the ``[Q, >=2k]`` ascending true-distance matrix.
    Contrast is ``d[2k-1] / d[k-1]``; the lower-contrast half is *hard*.
    Deterministic (stable argsort, ties by index).
    """
    if hasattr(exact_dist, "detach"):
        exact_dist = exact_dist.detach().cpu().numpy()
    exact_dist = np.asarray(exact_dist)
    if exact_dist.shape[1] < 2 * k:
        raise ValueError(f"need >= 2k={2 * k} true distances per query, "
                         f"got {exact_dist.shape[1]}")
    dk = np.maximum(exact_dist[:, k - 1], 1e-12)
    contrast = exact_dist[:, 2 * k - 1] / dk
    order = np.argsort(contrast, kind="stable")
    half = len(order) // 2
    return order[:half], order[half:]
