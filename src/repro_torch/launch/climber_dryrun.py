"""Dry-run of the paper's own technique at production scale (the JAX
package's ``repro.launch.climber_dryrun`` in PyTorch).

Counts the two distributed CLIMBER steps on the 16×16 (and 2×16×16) mesh
of ``meta`` slots — shapes only, nothing allocated — under a
:class:`~repro_torch.utils.roofline.CostCounter`:

  * :func:`build_step` — §V Step 4: PAA → P⁴ signatures → Algorithm-1
    group assignment → trie routing, for every record; each slot routes
    its own block of records (the Spark executors' semantics), zero
    collectives;
  * :func:`query_step` — §VI: featurise the queries → adaptive plan →
    ``compact_plan(…, 16)`` on the lead slot, then each slot's fused
    refine of its partitions and one gather of the slots' top-k lists to
    the lead, merged there (``core.refine.refine_sharded``, the port's
    sharded refine).

On ``meta`` the kernels (``paa``, ``pivot_rank``, ``refine_topk``) count
their own work through their work functions; ``refine_topk`` counts every
plan entry as a whole partition of ``cap`` rows for its query (a ``meta``
plan has no values).  Where the reference replicates featurize and
planning on every device, the port plans once on the lead slot, so the
per-device means carry 1/slots of it.

Scale: 128M series × 256 readings (the paper's 200GB-class RandomWalk
regime at c=3000 partition capacity), r=200 pivots, m=10 prefix, K=500,
50 queries per batch — the paper's §VII defaults.

Writes ``artifacts/torch/dryrun/climber_{build,query}_{mesh}.json``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.index import ClimberIndex, PartitionStore, _route_full_dataset
from repro_torch.core.query import compact_plan, plan_adaptive
from repro_torch.core.refine import refine_sharded
from repro_torch.core.traversal import TrieDevice
from repro_torch.core.trie import build_forest
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import roofline as RL
from repro_torch.utils.config import ClimberConfig

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "dryrun"

CFG = ClimberConfig(series_len=256, paa_segments=16, num_pivots=200,
                    prefix_len=10, capacity=3000, sample_frac=0.01,
                    max_centroids=512, k=500, candidate_groups=8,
                    adaptive_factor=4)
N_SERIES = 128_000_000
N_QUERIES = 50
PLAN_SLOTS = 16                 # compact_plan's budget: the refine's plan width


def synthetic_skeleton(cfg: ClimberConfig, num_groups: int = 256,
                       sample: int = 60_000, seed: int = 0, device="meta"):
    """Host-built skeleton with realistic shape statistics: the reference's
    numpy draws, so the reference's forest.  Returns ``(forest, trie,
    onehot)``, the trie and the ``[G, r]`` group one-hot on ``device``."""
    rng = np.random.default_rng(seed)
    sigs = np.stack([rng.choice(cfg.num_pivots, cfg.prefix_len, replace=False)
                     for _ in range(sample)]).astype(np.int32)
    freqs = rng.integers(1, 50, size=sample)
    groups = rng.integers(0, num_groups, size=sample)
    forest = build_forest(sigs, freqs, groups, num_groups, cfg.num_pivots,
                          capacity=float(cfg.capacity),
                          sample_frac=cfg.sample_frac)
    trie = TrieDevice.from_forest(forest, device)
    onehot = np.zeros((num_groups, cfg.num_pivots), np.float32)
    for g in range(1, num_groups):
        onehot[g, rng.choice(cfg.num_pivots, cfg.prefix_len, replace=False)] = 1
    return forest, trie, torch.as_tensor(onehot, device=device)


def production_mesh(multi_pod: bool, device="meta"):
    """The production mesh of ``device`` slots; every axis shards records."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[device] * (512 if multi_pod else 256))


def slot_rows(n: int, slots: int, d: int) -> Tuple[int, int]:
    """Slot ``d``'s block ``[lo, hi)`` of ``n`` records."""
    return d * n // slots, (d + 1) * n // slots


def build_step(blocks: Sequence[torch.Tensor], pivots: torch.Tensor,
               skeleton, cfg: ClimberConfig = CFG) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """§V Step 4 on every slot: each slot's ``[N_d, n]`` record block →
    its ``(partition, dfs tag)`` ``[N_d]`` int32, through ``paa`` and
    ``pivot_rank`` on the slot's device.  No slot reads another's rows."""
    _, trie, onehot = skeleton
    return [_route_full_dataset(x, pivots.to(x.device), onehot.to(x.device), trie, cfg)
            for x in blocks]


def query_step(index: ClimberIndex, queries: torch.Tensor, mesh, *,
               slots: Optional[Sequence[PartitionStore]] = None,
               plan_slots: int = PLAN_SLOTS):
    """§VI over a store laid out on ``mesh``: featurize → adaptive plan →
    ``compact_plan(…, plan_slots)`` on the lead slot, then each slot's
    fused refine of its partitions and one gather to the lead, merged
    there (``refine_sharded``).  Returns ``(dist, gid)`` ``[Q, k]``."""
    p4r_q, _ = index.featurize(queries)
    # compact the slot axis: the refine's work is Q × slots × cap rows, so
    # the static 2T × maxP padding must not reach it
    plan = compact_plan(plan_adaptive(index, p4r_q), plan_slots)
    return refine_sharded(index.store, queries, plan.sel_part, plan.sel_lo,
                          plan.sel_hi, index.cfg.k, mesh=mesh, slots=slots)


def meta_store(num_partitions: int, cfg: ClimberConfig = CFG) -> PartitionStore:
    """A ``[P, cap, n]`` store on ``meta``."""
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    p, cap = num_partitions, cfg.capacity
    return PartitionStore(data=e((p, cap, cfg.series_len), torch.float32),
                          norms=e((p, cap), torch.float32),
                          rec_dfs=e((p, cap), torch.int32),
                          rec_gid=e((p, cap), torch.int32),
                          count=e((p,), torch.int32))


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def run(kind: str, multi_pod: bool, *, n_series: int = N_SERIES,
        n_queries: int = N_QUERIES, cfg: ClimberConfig = CFG,
        skeleton_sample: int = 60_000) -> dict:
    """Count one step on the production mesh of ``meta`` slots (tests
    shrink ``n_series``, ``n_queries`` and the skeleton's sample)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    mesh = production_mesh(multi_pod)
    n_dev = mesh.size
    t0 = time.time()
    skeleton = synthetic_skeleton(cfg, sample=skeleton_sample)
    forest = skeleton[0]
    pivots = torch.zeros((cfg.num_pivots, cfg.paa_segments), device="meta")
    counter = RL.CostCounter(n_dev)
    if kind == "build":
        blocks = [torch.empty((b - a, cfg.series_len), device="meta")
                  for a, b in (slot_rows(n_series, n_dev, d) for d in range(n_dev))]
        args = blocks[0].numel() * 4
        outs_bytes = 2 * 4 * blocks[0].shape[0]
        with counter:
            build_step(blocks, pivots, skeleton, cfg)
        # useful work: one pass over every record (PAA+pivot dots dominate)
        useful_flops = n_series * (cfg.series_len + 2 * cfg.paa_segments * cfg.num_pivots)
        useful_bytes = n_series * cfg.series_len * 4
    else:
        p_total = ((n_series // cfg.capacity) // n_dev) * n_dev
        store = meta_store(p_total, cfg)
        index = ClimberIndex(cfg=cfg, pivots=pivots, centroid_onehot=skeleton[2],
                             forest=forest, trie=skeleton[1], store=store)
        from repro_torch.distributed.store import shard_store
        slots = shard_store(store, mesh)
        queries = torch.empty((n_queries, cfg.series_len), device="meta")
        args = _nbytes(slots[0]) + queries.numel() * 4
        outs_bytes = n_queries * cfg.k * 8
        with counter:
            query_step(index, queries, mesh, slots=slots)
        # useful work: ED refine over the selected partitions
        sel_rows = n_queries * 8 * cfg.capacity
        useful_flops = 2 * sel_rows * cfg.series_len
        useful_bytes = sel_rows * cfg.series_len * 4
    count_s = time.time() - t0

    report = RL.analyze("climber", kind, mesh_name, counter,
                        model_flops_total=useful_flops, num_devices=n_dev)
    report.model_bytes_per_device = useful_bytes / n_dev
    report.peak_memory_bytes = float(args + outs_bytes + counter.peak_per_device)
    res = {"status": "ok", "num_devices": n_dev,
           "partitions": forest.num_partitions, "count_s": count_s,
           "memory": {"argument_bytes": int(args), "output_bytes": int(outs_bytes),
                      "temp_bytes": int(counter.peak_per_device)},
           **report.to_dict()}
    print(f"[climber-{kind} × {mesh_name}] "
          f"args={args/2**30:.2f}GiB/dev "
          f"temp={counter.peak_per_device/2**30:.2f}GiB/dev "
          f"flops/dev={report.flops_per_device:.3g} "
          f"coll/dev={report.coll_bytes_per_device/1e6:.1f}MB "
          f"bottleneck={report.bottleneck} frac={report.roofline_fraction:.3f} "
          f"({count_s:.1f} s)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="both", choices=["build", "query", "both"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    kinds = ["build", "query"] if args.kind == "both" else [args.kind]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    ART.mkdir(parents=True, exist_ok=True)
    for kind in kinds:
        for multi in meshes:
            res = run(kind, multi)
            name = f"climber_{kind}_{'2x16x16' if multi else '16x16'}.json"
            (ART / name).write_text(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
