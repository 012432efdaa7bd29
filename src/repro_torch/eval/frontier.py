"""The recall-frontier runner: sweep the fleet and measure accuracy/cost.

The port of ``repro/eval/frontier.py``.  One :func:`run_frontier` call
sweeps, per dataset and shard count:

* **routing modes** — exhaustive (the lossless ceiling), fixed
  top-``fanout`` signature routing at several fanouts (the baseline
  frontier), and adaptive score-mass routing at several thresholds plus
  the threshold *learned* from audit traces
  (:meth:`~repro_torch.fleet.fleet.IndexFleet.calibrate_routing`);
* **planner spend** — the ``adaptive`` planner against recall-targeted
  variants at several spend factors
  (:func:`repro_torch.core.query.make_recall_target_planner`) and against
  reduced slot budgets (``query_max_slots``);

and scores every cell with tie-aware recall@k, MAP, and the data-touched
costs, stratified over hard / easy query splits
(:func:`repro_torch.eval.datasets.hardness_split`).  The output document
has the JAX package's layout:

* ``cells`` — flat metric rows;
* ``frontiers`` — per (dataset, shards, split) the (fraction-scanned,
  recall) curves for fixed vs adaptive routing with step AUC
  (:func:`repro_torch.eval.metrics.frontier_auc`);
* ``routed_gap`` — for each adaptive cell, the fixed-fanout curve's
  recall interpolated at the *same* candidates-scanned cost.

Corpora, queries, shards and the exact ground truth (Dss through the
``pairwise_l2`` kernel) live on ``device`` — the card unless the caller
names another.  Every random draw goes through one hook,
:class:`FrontierDraws`: the fleet's (:class:`~repro_torch.fleet.FleetDraws`)
plus each corpus's base series and motif steps and each query set's rows
and jitter, so a test can replay the JAX package's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.query import register_recall_target
from repro_torch.eval.datasets import (TenantCorpus, hardness_split,
                                       perturbed_queries, tenant_corpus)
from repro_torch.eval.ground_truth import GroundTruthCache
from repro_torch.eval.metrics import (_host, frontier_auc,
                                      mean_average_precision, recall_at_k)
from repro_torch.fleet.fleet import FleetConfig, FleetDraws, IndexFleet
from repro_torch.utils.config import ClimberConfig
from repro_torch.utils.device import DeviceLike, resolve_device

__all__ = ["FrontierSpec", "FrontierDraws", "run_frontier",
           "build_eval_fleet"]


@dataclass(frozen=True)
class FrontierSpec:
    """Everything that identifies one frontier sweep (seeds included)."""

    datasets: Tuple[str, ...] = ("randomwalk", "seismic")
    shard_counts: Tuple[int, ...] = (1, 4)
    shard_size: int = 1200
    series_len: int = 96
    num_queries: int = 48
    num_calibration: int = 32       # held-out queries for learn_threshold
    k: int = 10
    fanouts: Tuple[int, ...] = (1, 2, 3)
    thresholds: Tuple[float, ...] = (0.3, 0.6, 0.85, 0.95)
    spend_factors: Tuple[float, ...] = (1.0, 2.0, 4.0)
    slot_budgets: Tuple[int, ...] = (4, 16)   # query_max_slots overrides
    target_recall: float = 0.95     # calibrate_routing goal
    affinity: float = 0.6           # tenant motif strength
    noise: float = 0.1              # query perturbation
    seed: int = 0

    def shard_cfg(self) -> ClimberConfig:
        return ClimberConfig(
            series_len=self.series_len,
            paa_segments=max(self.series_len // 8, 1),
            num_pivots=48, prefix_len=6, capacity=128, sample_frac=0.25,
            max_centroids=16, k=self.k, candidate_groups=6,
            adaptive_factor=4)


class FrontierDraws(FleetDraws):
    """A sweep's random draws.  Each hook returns the draws or ``None``
    for :func:`tenant_corpus` / :func:`perturbed_queries` to draw their
    own from the seed (the default)."""

    def corpus(self, name: str, num_shards: int, shard_size: int,
               series_len: int, seed: int):
        """Per-shard base series and motif steps, or ``(None, None)``."""
        return None, None

    def queries(self, num_rows: int, num_queries: int, series_len: int,
                seed: int):
        """Union row indices and N(0, 1) jitter, or ``(None, None)``."""
        return None, None


def build_eval_fleet(corpus: TenantCorpus, spec: FrontierSpec, *,
                     device: DeviceLike = None,
                     draws: Optional[FleetDraws] = None) -> IndexFleet:
    """One sealed shard per corpus tenant; no plan cache (every cell must
    re-plan — the sweep mutates planner registrations and slot budgets)."""
    fcfg = FleetConfig(shard_cfg=spec.shard_cfg(), fanout=2,
                       plan_cache_size=0, seed=spec.seed)
    fleet = IndexFleet(fcfg, device=device, draws=draws)
    for i, block in enumerate(corpus.shards):
        fleet.add_shard(f"tenant{i}", block)
    return fleet


def _set_slot_budget(fleet: IndexFleet, budget: Optional[int]) -> None:
    """Apply a ``query_max_slots`` override to every sealed shard in place
    (and invalidate the placement, whose plan widths depend on it)."""
    for h in fleet.shards:
        cfg = h.index.cfg.replace(query_max_slots=budget)
        h.index = dataclasses.replace(h.index, cfg=cfg)
    with fleet._lock:
        fleet._invalidate_placement()


def _splits(exact_dist: np.ndarray, k: int,
            qn: int) -> Dict[str, np.ndarray]:
    hard, easy = hardness_split(exact_dist, k)
    return {"all": np.arange(qn), "hard": hard, "easy": easy}


def _measure(fleet: IndexFleet, queries: np.ndarray, k: int,
             gt_dist: np.ndarray, gt_idx: np.ndarray,
             splits: Dict[str, np.ndarray], identity: Dict,
             **query_kw) -> List[Dict]:
    """Run one fleet.query sweep cell and emit one metric row per split."""
    dist, gid, info = fleet.query(queries, k, **query_kw)
    rows = []
    for split, idx in splits.items():
        if len(idx) == 0:
            continue
        rows.append(dict(
            identity, split=split,
            recall=recall_at_k(gid[idx], gt_idx[idx, :k],
                               approx_dist=dist[idx],
                               exact_dist=gt_dist[idx, :k]),
            map=mean_average_precision(gid[idx], gt_idx[idx, :k]),
            mean_candidates_scanned=float(
                info.candidates_scanned[idx].mean()),
            mean_partitions_touched=float(
                info.partitions_touched[idx].mean()),
            mean_fanout=float(info.routed_mask[idx].sum(axis=1).mean())
            if info.routed_mask.size else 0.0,
        ))
    return rows


def _frontier_points(cells: Sequence[Dict], total: int
                     ) -> List[Tuple[float, float]]:
    return sorted((c["mean_candidates_scanned"] / total, c["recall"])
                  for c in cells)


def _interp_recall(points: Sequence[Tuple[float, float]],
                   cost: float) -> float:
    """Recall of a frontier at ``cost``, linearly interpolated (clamped to
    the endpoints) — the matched-cost baseline for ``routed_gap``."""
    if not points:
        return 0.0
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return float(np.interp(cost, xs, ys))


def run_frontier(spec: FrontierSpec, *,
                 cache_dir: Optional[Path] = None,
                 progress=None, device: DeviceLike = None,
                 draws: Optional[FrontierDraws] = None) -> Dict:
    """Execute the full sweep on ``device``; returns the artifact document
    (pure data).  ``draws`` replaces the sweep's random draws."""
    say = progress or (lambda *_: None)
    dev = resolve_device(device)
    draws = draws if draws is not None else FrontierDraws()
    gt_cache = GroundTruthCache(cache_dir) if cache_dir else None
    cells: List[Dict] = []
    frontiers: List[Dict] = []
    routed_gap: List[Dict] = []

    for ds in spec.datasets:
        for shards in spec.shard_counts:
            say(f"{ds} x {shards} shards: corpus + ground truth")
            bases, steps = draws.corpus(ds, shards, spec.shard_size,
                                        spec.series_len, spec.seed)
            corpus = tenant_corpus(
                ds, num_shards=shards, shard_size=spec.shard_size,
                series_len=spec.series_len, seed=spec.seed,
                affinity=spec.affinity, device=dev, bases=bases,
                motif_steps=steps)
            union = corpus.union
            qsets = []
            for num, seed in ((spec.num_queries, spec.seed),
                              (spec.num_calibration, spec.seed + 1)):
                idx, jitter = draws.queries(union.shape[0], num,
                                            spec.series_len, seed)
                qsets.append(perturbed_queries(
                    corpus, num, noise=spec.noise, seed=seed, idx=idx,
                    jitter=jitter))
            queries_t, calib_t = qsets
            meta = dict(corpus.meta(), num_queries=spec.num_queries,
                        noise=spec.noise, qseed=spec.seed)
            # 2k true neighbours: k for recall, 2k for the hardness ratio
            if gt_cache is not None:
                gt_dist, gt_idx = gt_cache.exact(meta, queries_t, union,
                                                 2 * spec.k)
            else:
                from repro_torch.baselines.dss import exact_knn
                gt_dist, gt_idx = map(_host, exact_knn(
                    queries_t, union, 2 * spec.k, chunk=2048))
            queries, calib_q = _host(queries_t), _host(calib_t)
            splits = _splits(gt_dist, spec.k, len(queries))
            fleet = build_eval_fleet(corpus, spec, device=dev, draws=draws)
            total = union.shape[0]
            # the shards hold their own stores: free the corpus on the card
            del corpus, union, queries_t, calib_t
            base = {"dataset": ds, "shards": shards,
                    "num_queries": spec.num_queries, "k": spec.k,
                    "slot_budget": 0, "variant": "adaptive"}

            # -- routing sweep (default budget, adaptive planner) --------
            say(f"{ds} x {shards}: routing sweep")
            exh = _measure(fleet, queries, spec.k, gt_dist, gt_idx, splits,
                           dict(base, routing="exhaustive", param="-"),
                           routing="exhaustive")
            cells += exh
            fixed_cells: Dict[str, List[Dict]] = {s: [] for s in splits}
            adapt_cells: Dict[str, List[Dict]] = {s: [] for s in splits}
            if shards > 1:
                for fo in spec.fanouts:
                    if fo > shards:
                        continue
                    rows = _measure(
                        fleet, queries, spec.k, gt_dist, gt_idx, splits,
                        dict(base, routing="signature",
                             param=f"fanout={fo}"),
                        routing="signature", fanout=fo)
                    cells += rows
                    for r in rows:
                        fixed_cells[r["split"]].append(r)
                # matched-cost baseline needs the ceiling too: top-S ==
                # exhaustive fan-out, at the exhaustive cell's cost
                for r in exh:
                    fixed_cells[r["split"]].append(r)
                for th in spec.thresholds:
                    rows = _measure(
                        fleet, queries, spec.k, gt_dist, gt_idx, splits,
                        dict(base, routing="adaptive", param=f"th={th}"),
                        routing="adaptive", threshold=th)
                    cells += rows
                    for r in rows:
                        adapt_cells[r["split"]].append(r)
                # learned threshold: audit on held-out queries, calibrate
                fleet.audit_routing(calib_q, spec.k, record=True)
                learned = fleet.calibrate_routing(spec.target_recall)
                rows = _measure(
                    fleet, queries, spec.k, gt_dist, gt_idx, splits,
                    dict(base, routing="adaptive",
                         param=f"learned={learned:.2f}"),
                    routing="adaptive")
                cells += rows
                for r in rows:
                    adapt_cells[r["split"]].append(r)

                for split in splits:
                    fpts = _frontier_points(fixed_cells[split], total)
                    apts = _frontier_points(adapt_cells[split], total)
                    frontiers.append({
                        "dataset": ds, "shards": shards, "split": split,
                        "fixed": fpts, "adaptive": apts,
                        "fixed_auc": frontier_auc(fpts),
                        "adaptive_auc": frontier_auc(apts)})
                    cells.append({
                        "dataset": ds, "shards": shards, "split": split,
                        "curve": "fixed",
                        "recall_frontier_auc": frontier_auc(fpts)})
                    cells.append({
                        "dataset": ds, "shards": shards, "split": split,
                        "curve": "adaptive",
                        "recall_frontier_auc": frontier_auc(apts)})
                    for c in adapt_cells[split]:
                        cost = c["mean_candidates_scanned"] / total
                        fixed_at = _interp_recall(fpts, cost)
                        routed_gap.append({
                            "dataset": ds, "shards": shards,
                            "split": split, "param": c["param"],
                            "frac_scanned": cost,
                            "adaptive_recall": c["recall"],
                            "fixed_recall_at_cost": fixed_at,
                            "improvement": c["recall"] - fixed_at})

            # -- planner spend sweep (exhaustive routing isolates it) ----
            say(f"{ds} x {shards}: planner spend sweep")
            for spend in spec.spend_factors:
                register_recall_target(spend)
                cells += _measure(
                    fleet, queries, spec.k, gt_dist, gt_idx, splits,
                    dict(base, routing="exhaustive",
                         param=f"spend={spend:g}",
                         variant="recall_target"),
                    routing="exhaustive", variant="recall_target")
            for budget in spec.slot_budgets:
                _set_slot_budget(fleet, budget)
                cells += _measure(
                    fleet, queries, spec.k, gt_dist, gt_idx, splits,
                    dict(base, routing="exhaustive", param="-",
                         slot_budget=budget),
                    routing="exhaustive", variant="adaptive")
            _set_slot_budget(fleet, None)
            del fleet       # before the next corpus lands on the card

    doc = {"spec": dataclasses.asdict(spec), "cells": cells,
           "frontiers": frontiers, "routed_gap": routed_gap}
    if gt_cache is not None:
        doc["ground_truth_cache"] = {"hits": gt_cache.hits,
                                     "misses": gt_cache.misses}
    return doc
