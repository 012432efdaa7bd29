"""Exact ground-truth caching for recall evaluation.

Exact kNN over a corpus is the one cost of an evaluation that dwarfs the
rest and never changes for a fixed (corpus, queries, k), so it is computed
once (``baselines.dss.exact_knn``, through the ``pairwise_l2`` kernel on
the card) and cached on disk.  The key is a content hash of the generating
parameters, the same as ``repro.eval.ground_truth``'s, and the files have
the same ``gt_<key>.npz`` layout (``dist``, ``idx``, ``meta``), so either
package reads a cache the other wrote.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.baselines.dss import exact_knn
from repro_torch.utils.device import DeviceLike, resolve_device

__all__ = ["GroundTruthCache"]


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor stays where it is; an array goes to ``device``."""
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


class GroundTruthCache:
    """Disk cache of exact kNN answers keyed by dataset identity."""

    def __init__(self, cache_dir: Path):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_for(meta: Dict) -> str:
        """Stable content hash of the generating parameters."""
        blob = json.dumps(meta, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha1(blob).hexdigest()[:16]

    def _path(self, key: str) -> Path:
        return self.cache_dir / f"gt_{key}.npz"

    def get(self, meta: Dict) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        p = self._path(self.key_for(meta))
        if not p.exists():
            return None
        with np.load(p) as z:
            self.hits += 1
            return z["dist"], z["idx"]

    def put(self, meta: Dict, dist: np.ndarray, idx: np.ndarray) -> None:
        p = self._path(self.key_for(meta))
        tmp = p.with_suffix(".tmp.npz")
        np.savez(tmp, dist=dist, idx=idx,
                 meta=json.dumps(meta, sort_keys=True))
        tmp.replace(p)          # atomic: a reader never sees a half write

    def exact(self, meta: Dict, queries, data, k: int, *, chunk: int = 2048,
              device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
        """Cached exact kNN: ``(dist [Q, k] ascending, idx [Q, k])`` as numpy.

        ``meta`` must uniquely describe ``(queries, data)``; ``k`` is folded
        in here.  Tensors are scanned where they lie; numpy arrays go to
        ``device`` (the card unless the caller names another).
        """
        full_meta = dict(meta, k=int(k))
        cached = self.get(full_meta)
        if cached is not None:
            return cached
        self.misses += 1
        dev = data.device if torch.is_tensor(data) else resolve_device(device)
        dist, idx = exact_knn(_on(queries, dev).to(dev), _on(data, dev), k,
                              chunk=chunk)
        dist, idx = dist.cpu().numpy(), idx.cpu().numpy()
        self.put(full_meta, dist, idx)
        return dist, idx
