"""Signature-prefix query routing across index shards.

Every shard of a fleet is a full CLIMBER index with its *own* pivots, so a
query's per-shard signature is only computable by featurizing against each
shard — too expensive as a routing primitive.  The router therefore owns one
fleet-level reference pivot set and describes each shard by a **pivot
summary**: the decay-weighted frequency profile of the shard's records'
P4→ rank-signature prefixes under those reference pivots (Def. 9 weights —
the same decay the OD/WD ladder uses, so a pivot that is the nearest
neighbour of many shard records dominates the summary).

Routing scores a query's own weighted signature profile against every
summary with one ``[Q, r] @ [r, S]`` matmul and fans out to the top
``fanout`` shards per query.  Exhaustive fan-out (every shard) is the
lossless fallback — the Lernaean-Hydra lesson is that naive candidate
pruning collapses recall, so the routed mode is always an explicit,
measurable trade (``IndexFleet.audit_routing`` reports its precision
against the exhaustive oracle).

The port (``repro_torch``): profiles are computed on the fleet's device
through the ``paa`` and ``pivot_rank`` kernels; summaries, scores and
every routing rule run on the host in numpy, in the JAX package's
arithmetic, so the same pivots and data give the same scores.  The
reference pivots are rows of the sample picked by index (``pivot_idx``),
which the fleet draws through its draw hook; with
``pivot_method="maxmin"`` the hook draws the farthest-point start row.

A global top-``fanout`` constant spends the same budget on every query,
which is exactly what the Hydra evaluations show collapsing recall: easy
queries waste fan-out while ambiguous ones are starved.
:meth:`SignatureRouter.route_adaptive` instead selects, per query, the
smallest score-ordered shard prefix covering a ``threshold`` fraction of
the query's total score mass — confident queries route to one shard,
ambiguous ones to many.  ``threshold → 0`` degrades to top-1 routing and
``threshold >= 1`` is exactly exhaustive fan-out; the mask grows
monotonically with the threshold in between (property-tested).  The
threshold itself can be learned from ``IndexFleet.audit_routing`` traces
via :meth:`learn_threshold` (smallest threshold whose predicted coverage
of the true answers reaches a recall target).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.pivots import select_pivots
from repro_torch.core.signatures import decay_weights, weighted_onehot
from repro_torch.kernels import ops
from repro_torch.utils.config import ClimberConfig


class SignatureRouter:
    """Scores query signature profiles against per-shard pivot summaries."""

    def __init__(self, pivots: torch.Tensor, cfg: ClimberConfig):
        self.pivots = pivots                       # [r, w] reference pivots
        self.cfg = cfg
        self._weights = decay_weights(cfg.prefix_len, cfg.decay,
                                      cfg.decay_lambda, device=pivots.device)
        self.keys: List[str] = []
        self._summaries: List[np.ndarray] = []     # each [r], L2-normalized
        self.threshold: Optional[float] = None     # learned score-mass cut

    @classmethod
    def from_sample(cls, sample: torch.Tensor, cfg: ClimberConfig, *,
                    pivot_idx, pivot_method: str = "random"
                    ) -> "SignatureRouter":
        """Build the reference pivots from the first data the fleet sees,
        on its device: the PAA rows ``pivot_idx`` (``[r]``) of ``sample``,
        or with ``pivot_method="maxmin"`` the farthest-point pivots from
        the single row ``pivot_idx``."""
        z = ops.paa(sample.float(), cfg.paa_segments)
        idx = torch.as_tensor(np.asarray(pivot_idx, np.int64), device=z.device)
        want = () if pivot_method == "maxmin" else (cfg.num_pivots,)
        if idx.shape != want:
            raise ValueError(f"pivot_idx has shape {tuple(idx.shape)}, "
                             f"expected {want}")
        return cls(select_pivots(z, cfg.num_pivots, idx=idx,
                                 method=pivot_method).contiguous(), cfg)

    @property
    def num_shards(self) -> int:
        return len(self._summaries)

    # -- profiles ---------------------------------------------------------
    def _profile(self, series) -> torch.Tensor:
        """``[N, r]`` profile on the pivots' device (paa + pivot_rank)."""
        x = torch.as_tensor(series, dtype=torch.float32,
                            device=self.pivots.device)
        z = ops.paa(x, self.cfg.paa_segments)
        p4r = ops.pivot_rank(z, self.pivots, self.cfg.prefix_len)
        return weighted_onehot(p4r, self.pivots.shape[0], self._weights)

    def signature_profile(self, series) -> np.ndarray:
        """``[N, r]`` decay-weighted P4→ profile under the reference pivots."""
        return self._profile(series).cpu().numpy()

    def summarize(self, series) -> np.ndarray:
        """One shard's pivot summary: its records' mean profile, normalized.

        The sum over records runs on the device in float64 (exact for the
        default exponential decay, whose weights are powers of 2) and is
        cast to float32; the norm and the division are the JAX package's
        numpy."""
        prof = self._profile(series).double().sum(dim=0).float().cpu().numpy()
        norm = float(np.linalg.norm(prof))
        return (prof / norm if norm else prof).astype(np.float32)

    # -- shard registry (parallel to the fleet's shard list) --------------
    def register(self, key: str, summary: np.ndarray) -> None:
        self.keys.append(key)
        self._summaries.append(np.asarray(summary, dtype=np.float32))

    def replace_span(self, pos: int, count: int, key: Optional[str] = None,
                     summary: Optional[np.ndarray] = None) -> None:
        """Splice the registry: drop ``count`` entries at ``pos`` and, when
        ``key`` is given, insert its ``(key, summary)`` in their place.

        The registry must stay index-parallel to the fleet's shard list;
        this is how lifecycle maintenance (shard merge / retirement —
        ``repro_torch.fleet.lifecycle.merge``) keeps it that way.
        """
        ins_keys = [key] if key is not None else []
        ins_sums = [np.asarray(summary, dtype=np.float32)] \
            if key is not None else []
        self.keys[pos: pos + count] = ins_keys
        self._summaries[pos: pos + count] = ins_sums

    # -- routing ----------------------------------------------------------
    def score(self, queries: np.ndarray) -> np.ndarray:
        """``[Q, S]`` affinity of each query to each registered shard."""
        if not self._summaries:
            return np.zeros((len(queries), 0), np.float32)
        prof = self.signature_profile(queries)             # [Q, r]
        return prof @ np.stack(self._summaries, axis=1)    # [Q, S]

    def route(self, queries: np.ndarray, fanout: int,
              scores: Optional[np.ndarray] = None) -> np.ndarray:
        """Boolean ``[Q, S]`` mask of the top-``fanout`` shards per query."""
        s = self.num_shards
        mask = np.zeros((len(queries), s), dtype=bool)
        if s == 0:
            return mask
        if fanout >= s:
            mask[:] = True
            return mask
        sc = self.score(queries) if scores is None else scores
        top = np.argpartition(-sc, fanout - 1, axis=-1)[:, :fanout]
        np.put_along_axis(mask, top, True, axis=-1)
        return mask

    def route_adaptive(self, queries: np.ndarray, threshold: float, *,
                       min_fanout: int = 1,
                       max_fanout: Optional[int] = None,
                       scores: Optional[np.ndarray] = None) -> np.ndarray:
        """Boolean ``[Q, S]`` mask covering ``threshold`` of the score mass.

        Shards are visited in descending score order and a query keeps
        adding shards while the mass *before* the next shard is still below
        ``threshold`` — so every query gets its best shard, a confident
        query stops there, and an ambiguous one (flat scores) fans wide.

        Contracts (property-tested):
          * ``threshold >= 1.0`` → all-True, bit-identical to exhaustive.
          * ``threshold <= 0.0`` → exactly the top-``min_fanout`` shards.
          * the mask grows monotonically with ``threshold`` and is always
            a superset of :meth:`route` at ``fanout=min_fanout``.
          * ``max_fanout`` caps the per-query row sum when given.
        """
        s = self.num_shards
        mask = np.zeros((len(queries), s), dtype=bool)
        if s == 0:
            return mask
        if threshold >= 1.0 and max_fanout is None:
            mask[:] = True                 # exhaustive short-circuit: no
            return mask                    # float cumsum at the boundary
        sc = self.score(queries) if scores is None else scores
        sc = np.asarray(sc, dtype=np.float64)
        order = np.argsort(-sc, axis=-1, kind="stable")   # ties → low index
        # strictly positive mass keeps the prefix rule meaningful even for
        # all-zero or negative score rows (degrades to uniform mass)
        mass = np.take_along_axis(sc, order, axis=-1)
        mass = np.maximum(mass - mass.min(axis=-1, keepdims=True), 0.0)
        mass = mass + 1e-9
        total = mass.sum(axis=-1, keepdims=True)
        frac_before = (np.cumsum(mass, axis=-1) - mass) / total
        rank = np.arange(s)[None, :]
        sel = (frac_before < threshold) | (rank < max(1, min_fanout))
        if max_fanout is not None:
            sel &= rank < max_fanout
        np.put_along_axis(mask, order, sel, axis=-1)
        return mask

    def learn_threshold(self, traces, target_recall: float = 0.95, *,
                        grid: Optional[np.ndarray] = None) -> float:
        """Fit the score-mass threshold from ``audit_routing`` traces.

        ``traces`` is a sequence of ``(scores, true_hits)`` pairs — per
        query, the router's ``[S]`` shard scores and the ``[S]`` count of
        exhaustive-oracle answers living in each shard.  For each candidate
        threshold the predicted recall is the fraction of true answers
        inside the shards :meth:`route_adaptive` would select; the learned
        threshold is the smallest one whose mean predicted recall reaches
        ``target_recall`` (else the largest grid point).  Stored on
        ``self.threshold`` and returned.
        """
        if grid is None:
            grid = np.linspace(0.0, 1.0, 21)
        traces = [(np.asarray(sc, np.float64), np.asarray(h, np.float64))
                  for sc, h in traces]
        traces = [(sc, h) for sc, h in traces if h.sum() > 0]
        if not traces:
            self.threshold = float(grid[-1])
            return self.threshold
        sc_all = np.stack([sc for sc, _ in traces])        # [T, S]
        hits = np.stack([h for _, h in traces])            # [T, S]
        best = float(grid[-1])
        for th in grid:
            m = self.route_adaptive(np.empty((len(sc_all), 0)), float(th),
                                    scores=sc_all)
            covered = (hits * m).sum(axis=-1) / hits.sum(axis=-1)
            if float(covered.mean()) >= target_recall:
                best = float(th)
                break
        self.threshold = best
        return best
