#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Drives the port's five paths once on one NVIDIA card, at the paper's
configuration (``ClimberConfig()``: n=256, w=16, r=200, m=10, c=3000,
K=500), with every kernel's launch count zeroed just before each path and
read just after it:

1. **serve**: generates a z-normalised random-walk dataset on the card from
   ``--seed``, builds the CLIMBER index on the card, and serves queries
   drawn from the dataset through ``ClimberEngine`` (adaptive at batch 64,
   k=500; ``knn`` and ``od_smallest`` one batch each).
2. **evaluation** (Fig. 7): for the main dataset and for ``sift``, ``dna``,
   ``eeg`` and ``seismic`` at ``--other-num`` series each, the exact ground
   truth of 64 queries by Dss (``GroundTruthCache`` → ``exact_knn`` → the
   ``pairwise_l2`` kernel), then CLIMBER (``adaptive``, ``knn``,
   ``recall_target`` at spend 2), DPiSAX and TARDIS (cardinality 8,
   capacity c), each scored by tie-aware recall@K and MAP; DPiSAX also
   answers through the dense refine (the ``qdots`` kernel), held against
   its fused answer.  Every method runs over the whole dataset.  Last, a
   seismic tenant corpus (4 shards, affinity 0.6) with perturbed queries,
   2K true neighbours and the hard/easy split.
3. **fleet**: a seismic tenant corpus of 4 × ``--fleet-shard`` series
   (affinity 0.6), one ``IndexFleet.add_shard`` per tenant; 256 perturbed
   queries through ``FleetEngine`` (batch 64, k=500, signature routing,
   fan-out 2, adaptive) with ``placement="host"`` and ``"mesh"`` (the
   stacked one-card pass), which must agree bit for bit, scored against
   ``scan_exact``; one exhaustive fan-out batch against ``scan_exact`` and
   ``scan_exact`` against Dss; the online recall sentinel on the same 256
   queries (``sentinel_rate=0.05``, recalibration every 4 audits, two
   audits after each tick, then ``drain()``: answers bit-equal with it on
   and off, the audits exactly the queries its seeded RNG draws, their mean
   recall equal to ``recall_at_k`` against Dss through the plain
   ``pairwise_l2``); ingest under load (64 insert batches of
   1,024 rows into a WAL-durable fleet under ``build/``, each followed by a
   serving tick that runs maintenance, so the delta seals twice in the
   background; acknowledged rows must read back at once), a 4-batch WAL
   tail, ``save()`` and ``IndexFleet.open()`` (answers bit-equal), and a
   ``maintenance`` merge of the two sealed delta shards (exhaustive answers
   unchanged).  After its launch counts are read, ``refine_topk`` is held
   against its plain version at two of the fleet's shapes: one shard's
   stacked-pass plan and ``scan_exact``'s exhaustive refine over the union
   store.
4. **net**, on that fleet: ``serve_in_thread(FleetEngine(fleet, batch
   size 64, k=500, signature routing, fan-out 2))`` on 127.0.0.1 (its
   admission sized for 256 requests in flight), 256 queries through one
   pipelined ``ClimberClient.query_batch``, then 4 concurrent clients × 64
   single queries that retry on ``RetryLater``, each client a process of
   its own; the metrics page, the
   flight recorder's traces and the health card over the same socket.
   Every socket answer must equal ``IndexFleet.query`` bit for bit and the
   server must drain and stop.  After its launch counts are read,
   ``refine_topk`` is held against its plain version on a two-row tick's
   plans over every sealed shard and over the live delta.
5. **frontier**: ``run_frontier`` at ``ClimberConfig()`` (a spec subclass
   whose ``shard_cfg()`` returns it) over ``randomwalk`` and ``seismic``
   tenant corpora at 1 and 4 shards of ``--frontier-shard`` series, 64
   queries, 32 calibration queries, the spec's fan-outs, thresholds, spend
   factors (1, 2, 4) and slot budgets (4, 16), ground truth by Dss
   through a ``GroundTruthCache``.  Hard checks: exhaustive routing scans at
   least as much as every routed cell; a slot budget b touches at most
   b × shards partitions; on seismic × 4, a fresh evaluation fleet scans
   as the sweep did, and its exhaustive routing with the exhaustive planner
   and the sweep's cached ground truth both give the answer of Dss through
   the plain ``pairwise_l2`` up to k-th-distance ties.  After its launch
   counts are read, ``pairwise_l2`` is held against its plain version on
   one Dss chunk of the sweep (64 queries × 2,048 series), and
   ``refine_topk`` on shard 0's exhaustive and spend-4 plans.

Then, off the paths, it holds each CUDA kernel against its plain PyTorch
version on the same inputs at the paths' shapes, times both with CUDA
events (and the one PyTorch call that computes the same function, where
there is one; ``pivot_rank`` also at one tick's 64 query rows, with the
profiler's device time; ``refine_topk`` on three plans — adaptive on
queries 0-63, adaptive on the traced tick's queries 64-127, and
``od_smallest`` — each with the (query, record) pairs it keeps, the
distinct records behind them and its byte bound), reads each redesigned
kernel's registers and spills from the ``ptxas`` build log, traces one more adaptive tick with
``torch.profiler`` (device busy time and idle share), checks the engine
against per-query ``knn_query``, and requires the exhaustive plan to
reproduce the Dss answer up to k-th-distance ties.  Any failed check raises and the script exits
non-zero.  Output, in order: phase lines, one ``{"kernels": [...]}`` JSON
line, the card's ``nvidia-smi`` name and power limit, and the last line
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes a longer
JSON report there.

Usage: ``python3 chip_smoke.py [--seed 0] [--num 4194304] [--queries 256]
[--other-num 1048576] [--tenant-shard 262144] [--fleet-shard 1048576]
[--frontier-shard 1048576] [--report PATH]``
from the repository root (it puts ``src/`` on ``sys.path`` itself).  It
needs a CUDA card and ``nvcc``; without a card it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# non-tensor fp32 FLOP/s.  The roofline bound of a kernel is the larger of
# its bytes over the first and its FLOPs over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def say(*parts) -> None:
    print(*parts, flush=True)


def ptxas_table(log: str):
    """``{kernel entry: {"registers", "spill_stores", "spill_loads"}}`` from
    nvcc's ``-Xptxas -v`` output, entry names demangled where a demangler
    is on the machine."""
    table, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            entry = ln.split("'")[1]
            table[entry] = {}
        elif entry and "bytes spill stores" in ln:
            f = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
            table[entry].update(spill_stores=f[1], spill_loads=f[2])
        elif entry and "Used" in ln and "registers" in ln:
            table[entry]["registers"] = int(ln.split("Used")[1].split()[0])
    for tool in ("cu++filt", "/usr/local/cuda/bin/cu++filt", "c++filt"):
        if shutil.which(tool) and table:
            out = subprocess.run([tool], input="\n".join(table), text=True,
                                 capture_output=True).stdout.splitlines()
            if len(out) == len(table):
                names = (o.replace("void ", "").replace("(int)", "").replace(
                    "(bool)", "").split("::", 1)[-1].split("(")[0] for o in out)
                return dict(zip(names, table.values()))
    return table


SERVE_KERNELS = ("paa", "pivot_rank", "refine_topk")
EVAL_QUERIES = 64
SCAN_CHUNK = 1 << 20          # Dss rows per pairwise_l2 launch


def sync_wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, card synchronised."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def assert_same_topk(label, d2_a, g_a, d2_b, g_b, tol):
    """The refine_topk rule: ``|Δd²| ≤ tol`` per query, and answer sets that
    differ only at the k-th distance (a near-tie under another summation
    order).  Returns (max |Δd²|, queries whose gids differ)."""
    import torch
    derr = (d2_a - d2_b).abs()
    if bool((derr > tol).any()):
        raise SystemExit(f"{label}: |Δd²| {float(derr.max())} exceeds "
                         f"1e-5·(‖q‖²+‖x‖²)")
    kth = d2_b[:, -1:]
    differ = (g_a != g_b).any(1)
    for i in differ.nonzero()[:, 0].tolist():
        extra = torch.tensor(sorted(set(g_a[i].tolist()) - set(g_b[i].tolist())),
                             device=g_a.device, dtype=g_a.dtype)
        if extra.numel():
            d_extra = d2_a[i][torch.isin(g_a[i], extra)]
            if bool(((d_extra - kth[i]).abs() > tol[i]).any()):
                raise SystemExit(f"{label}: query {i} answer set differs "
                                 f"away from the k-th distance")
    return float(derr.max()), int(differ.sum())


def l2_check(label, q, x):
    """``pairwise_l2`` against its plain version on ``q`` × ``x``:
    ``|Δd²| ≤ 1e-5·(‖q‖²+‖x‖²)`` per entry.  Returns max |Δd²|."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.l2 import pairwise_l2_plain
    assert not torch.backends.cuda.matmul.allow_tf32
    d_k = ops.pairwise_l2(q, x)
    d_p = pairwise_l2_plain(q, x)
    tol = 1e-5 * ((q * q).sum(-1, keepdim=True) + (x * x).sum(-1)[None, :])
    err = (d_k - d_p).abs()
    if bool((err > tol).any()):
        raise SystemExit(f"{label}: |Δd²| {float(err.max())} exceeds "
                         f"1e-5·(‖q‖²+‖x‖²)")
    return float(err.max())


def plain_exact_knn(queries, data, k, chunk=SCAN_CHUNK):
    """Dss through ``pairwise_l2``'s plain version, a running top-k over
    ``chunk``-row slices: ``(d² [Q, k], row ids)``.  The reference that
    checks kernel answers independently of every kernel."""
    import torch
    from repro_torch.kernels.l2 import pairwise_l2_plain
    from repro_torch.kernels.refine_topk import topk_flat
    best_d = best_i = None
    for a in range(0, data.shape[0], chunk):
        d2 = pairwise_l2_plain(queries, data[a:a + chunk])
        ids = torch.arange(a, a + d2.shape[1], dtype=torch.int32,
                           device=d2.device).expand_as(d2)
        if best_d is not None:
            d2, ids = torch.cat([best_d, d2], 1), torch.cat([best_i, ids], 1)
        best_d, best_i = topk_flat(d2, ids, k)
    return best_d, best_i


def evaluate_dataset(name, data, queries, index, gt_cache, meta, cfg, gen):
    """Fig. 7 on one dataset: Dss truth, then CLIMBER, DPiSAX, TARDIS.

    Returns (rows, truth): one row per method, and the Dss answer over the
    whole dataset ``(dist, idx)`` as numpy.
    """
    import numpy as np
    import torch
    from repro_torch.baselines import (build_dpisax, build_tardis, dpisax_knn,
                                       tardis_knn)
    from repro_torch.core.query import knn_query
    from repro_torch.eval import mean_average_precision, recall_at_k

    k, nq, num = cfg.k, queries.shape[0], data.shape[0]
    m = dict(meta, rows=num)
    (d_gt, i_gt), secs = sync_wall(lambda: gt_cache.exact(
        m, queries, data, k, chunk=SCAN_CHUNK))
    say(f"  dss[{name}]: exact {k}-NN of {nq} queries over {num} series "
        f"in {secs:.3f} s ({-(-num // SCAN_CHUNK)} pairwise_l2 launches)")
    rows_out = []
    q2 = (queries.double() ** 2).sum(-1, keepdim=True)

    def score(method, dist, gid, secs, **extra):
        dist, gid = dist.cpu().numpy(), gid.cpu().numpy()
        row = {"dataset": name, "method": method, "rows": num,
               "recall": recall_at_k(gid, i_gt, k, approx_dist=dist,
                                     exact_dist=d_gt),
               "map": mean_average_precision(gid, i_gt, k),
               "ms_per_query": secs / nq * 1e3, **extra}
        rows_out.append(row)
        say(f"fig7[{name}] {method}: " + json.dumps(
            {a: (round(b, 4) if isinstance(b, float) else b) for a, b in row.items()
             if a not in ("dataset", "method")}))

    for variant in ("adaptive", "knn", "recall_target"):
        knn_query(index, queries[:8], k, variant=variant)          # warm-up
        (d, g, qp), secs = sync_wall(lambda: knn_query(index, queries, k,
                                                       variant=variant))
        score(f"climber-{variant}", d, g, secs,
              mean_partitions_touched=float(qp.partitions_touched().float().mean()))

    w = cfg.paa_segments
    dp, build_s = sync_wall(lambda: build_dpisax(
        data, segments=w, cardinality=8, capacity=cfg.capacity, device=data.device))
    dpisax_knn(dp, queries[:8], k)                                   # warm-up
    (d, g), secs = sync_wall(lambda: dpisax_knn(dp, queries, k))
    # the same queries through the dense refine (the qdots kernel)
    (d_dense, g_dense), secs_dense = sync_wall(
        lambda: dpisax_knn(dp, queries, k, use_kernel=False))
    tol = 1e-5 * (q2 + float(dp.store.norms.max()))
    err, differ = assert_same_topk(f"dpisax[{name}] dense vs fused",
                                   d_dense.double() ** 2, g_dense,
                                   d.double() ** 2, g, tol)
    score("dpisax", d, g, secs, build_s=build_s,
          partitions=dp.num_partitions, cap=dp.store.capacity,
          store_gb=dp.store.data.numel() * 4 / 1e9,
          dense_ms_per_query=secs_dense / nq * 1e3,
          dense_vs_fused_max_abs_err=err, dense_vs_fused_gid_queries=differ)
    del dp, d_dense, g_dense
    td, build_s = sync_wall(lambda: build_tardis(
        data, segments=w, cardinality=8, capacity=cfg.capacity,
        sample_frac=cfg.sample_frac, generator=gen, device=data.device))
    tardis_knn(td, queries[:8], k)                                   # warm-up
    (d, g), secs = sync_wall(lambda: tardis_knn(td, queries, k))
    score("tardis", d, g, secs, build_s=build_s,
          partitions=td.forest.num_partitions, cap=td.store.capacity,
          store_gb=td.store.data.numel() * 4 / 1e9)
    del td
    torch.cuda.empty_cache()
    return rows_out, (d_gt, i_gt)


FLEET_KERNELS = ("paa", "pivot_rank", "refine_topk")
FLEET_TENANTS = 4
INSERT_BATCHES, INSERT_ROWS, TAIL_BATCHES = 64, 1024, 4


def plain_refine_chunked(store, qs, sp, lo, hi, k, budget=4e9):
    """``refine_topk``'s plain version over a partition-sorted plan, in
    query chunks and, where the plan names each partition once (an
    exhaustive plan), in chunks of partition columns, each gathering at
    most ``budget`` bytes of rows; the chunks' top-k lists are merged by
    (d², column), the order of one plain pass."""
    import torch
    from repro_torch.kernels.refine_topk import masked_distances, topk_flat
    live_w = int((sp >= 0).sum(1).max())
    sp, lo, hi = (t[:, t.shape[1] - live_w:] for t in (sp, lo, hi))  # pads first
    per = store.capacity * store.data.shape[-1] * 4
    cols = max(1, min(live_w, int(budget // per)))
    if cols < live_w and bool(((sp[:, 1:] == sp[:, :-1]) & (sp[:, 1:] >= 0)).any()):
        raise SystemExit("plain refine: a repeated partition cannot be split "
                         "across column chunks")
    qc = max(1, int(budget // (cols * per)))
    out_d, out_g = [], []
    for a in range(0, qs.shape[0], qc):
        parts = [topk_flat(*masked_distances(
            store.data, store.norms, store.rec_dfs, store.rec_gid, qs[a:a + qc],
            sp[a:a + qc, c:c + cols], lo[a:a + qc, c:c + cols],
            hi[a:a + qc, c:c + cols]), k) for c in range(0, live_w, cols)]
        d, g = topk_flat(torch.cat([x[0] for x in parts], 1),
                         torch.cat([x[1] for x in parts], 1), k)
        out_d.append(d)
        out_g.append(g)
    return torch.cat(out_d), torch.cat(out_g), live_w


def refine_plan_checks(path, qs, k, cases) -> dict:
    """``refine_topk`` against its plain version on each ``(label, store,
    (sel_part, sel_lo, sel_hi))`` of ``cases``, the plan sorted by
    partition as the kernel's wrapper sorts it (stable, pads first).  Run
    after the path's launch counts are read, so these launches are not
    counted.  Returns one row per case."""
    import torch
    from repro_torch.kernels.refine_topk import refine_topk
    out = {}
    for label, store, plan in cases:
        order = torch.argsort(plan[0], dim=-1, stable=True)
        sp, lo, hi = (torch.gather(t, 1, order).to(torch.int32).contiguous()
                      for t in plan)
        (d2_k, g_k), secs = sync_wall(lambda: refine_topk(
            store.data, store.norms, store.rec_dfs, store.rec_gid, qs, sp, lo, hi, k))
        d2_p, g_p, live_w = plain_refine_chunked(store, qs, sp, lo, hi, k)
        tol = 1e-5 * ((qs * qs).sum(-1, keepdim=True) + float(store.norms.max()))
        err, differ = assert_same_topk(f"refine_topk [{path} {label}]", d2_k, g_k,
                                       d2_p, g_p, tol)
        out[label] = {"Q": qs.shape[0], "P": store.num_partitions,
                      "cap": store.capacity, "mp": sp.shape[1], "live_width": live_w,
                      "max_abs_err": err, "gid_queries_differ": differ,
                      "kernel_s": secs}
        say(f"refine_topk [{path} {label}]: max |Δd²| {err:.3g}; {differ} of "
            f"{qs.shape[0]} queries differ in gid order at near-ties; "
            + json.dumps(out[label], default=float))
        del d2_p, g_p
    return out


def host_plan(index, qs, variant):
    """The host loop's plan of ``qs`` on one index: featurize, then the
    ``variant`` planner (``IndexFleet._query_sealed_host``)."""
    from repro_torch.core.query import plan
    qp = plan(index, index.featurize(qs)[0], variant=variant)
    return qp.sel_part, qp.sel_lo, qp.sel_hi


def fleet_refine_checks(fleet, qs, k) -> dict:
    """``refine_topk`` at two of the fleet path's shapes: shard 0's
    stacked-pass plan (the pass's padded plan width, over the shard's own
    store) and ``scan_exact``'s exhaustive refine over the union store."""
    from repro_torch.core.query import exhaustive_selection
    from repro_torch.kernels import ops
    pl = fleet._ensure_placement()
    qp = pl.plan_shard(0, ops.paa(qs, fleet.cfg.shard_cfg.paa_segments), "adaptive")
    union = fleet._union_store()
    return refine_plan_checks("fleet", qs, k, (
        ("stacked pass, shard " + fleet.shards[0].key, fleet.shards[0].index.store,
         (qp.sel_part, qp.sel_lo, qp.sel_hi)),
        ("scan_exact union", union,
         exhaustive_selection(union.num_partitions, qs.shape[0], qs.device))))


def net_refine_checks(fleet, qs, k) -> dict:
    """``refine_topk`` at the net path's shapes: a socket tick's few rows
    over every sealed shard's stacked-pass plan and over the live delta
    (its one-partition bootstrap store, or its own index's plan)."""
    import torch
    from repro_torch.kernels import ops
    pl = fleet._ensure_placement()
    z = ops.paa(qs, fleet.cfg.shard_cfg.paa_segments)
    cases = []
    for j, shard in enumerate(fleet.shards):
        qp = pl.plan_shard(j, z, "adaptive")
        cases.append((f"stacked pass, shard {shard.key}", shard.index.store,
                      (qp.sel_part, qp.sel_lo, qp.sel_hi)))
    delta = fleet.delta
    if delta.occupancy:
        if delta.index is None:
            sel = torch.zeros((qs.shape[0], 1), dtype=torch.int32, device=qs.device)
            cases.append(("delta", delta.store(), (sel, sel, sel + 1)))
        else:
            cases.append(("delta", delta.index.store,
                          host_plan(delta.index, qs, "adaptive")))
    return refine_plan_checks("net", qs, k, cases)


def serve_queue(eng, q_np, k):
    """``q_np`` through the engine's queue (``submit_request`` then one
    ``step`` per tick, so ``_after_tick`` runs); returns (dist, gid, host ms
    of each tick)."""
    import numpy as np
    import torch
    from repro_torch.serve import QueryRequest
    tickets = [eng.submit_request(QueryRequest(series=q, k=k, request_id=i))
               for i, q in enumerate(q_np)]
    ticks = []
    while eng.queue:
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        ticks.append((time.perf_counter() - t) * 1e3)
    if not all(t.ok for t in tickets):
        raise SystemExit("fleet: a queued request was not answered")
    return (np.stack([t.result.dist for t in tickets]),
            np.stack([t.result.gid for t in tickets]), ticks)


def sentinel_check(fleet, union, q_np, k, bs) -> dict:
    """The online recall sentinel on the fleet path's traffic: the 256
    queries through ``FleetEngine`` with the sentinel off, then on
    (``sentinel_rate=0.05``, recalibration every 4 audits; two audits after
    each tick), then ``drain()``.  Hard checks: answers bit-equal on and
    off; the audits are the samples that the sentinel's seeded RNG draws
    from the batches handed to ``observe``, and their mean recall equals
    ``recall_at_k`` of those served answers against Dss over ``union``
    (the fleet's rows in global-id order) through the plain
    ``pairwise_l2``."""
    import numpy as np
    import torch
    from repro_torch.eval import recall_at_k
    from repro_torch.fleet import FleetEngine
    from repro_torch.obs import REGISTRY

    kw = dict(batch_size=bs, k=k, routing="signature", fanout=2,
              variant="adaptive", placement="mesh")
    serve_queue(FleetEngine(fleet, **kw), q_np, k)     # every plan cached
    d_off, g_off, ticks_off = serve_queue(FleetEngine(fleet, **kw), q_np, k)
    rate = 0.05
    eng = FleetEngine(fleet, sentinel_rate=rate, sentinel_recalibrate_every=4, **kw)
    sentinel, batches = eng.sentinel, []
    observe = sentinel.observe

    def keep(queries, k_, dist, gid):     # every batch the fleet hands over
        batches.append((queries.copy(), dist.copy(), gid.copy()))
        observe(queries, k_, dist, gid)

    sentinel.observe = keep
    span_hist = REGISTRY.histogram("span.sentinel.audit")
    span_hist.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        d_on, g_on, ticks_on = serve_queue(eng, q_np, k)
        in_ticks = sentinel.snapshot()["audits"]
        pending = sentinel.pending()
        (drained, drain_s) = sync_wall(sentinel.drain)
    finally:
        fleet.sentinel = None
    if not (np.array_equal(d_on, d_off) and np.array_equal(g_on, g_off)):
        raise SystemExit("sentinel: served answers differ with the sentinel on")
    snap = sentinel.snapshot()
    # the samples: the sentinel's RNG (FleetEngine's seed 0) over the batches
    rng = np.random.default_rng(0)
    picks = [(q[i], d[i], g[i]) for q, d, g in batches
             for i in np.nonzero(rng.random(len(q)) < rate)[0]]
    if not picks or snap["audits"] != len(picks):
        raise SystemExit(f"sentinel: {snap['audits']} audits for {len(picks)} "
                         f"sampled queries")
    q_s, d_s, g_s = (np.stack(x) for x in zip(*picks))
    t_d2, t_i = plain_exact_knn(torch.as_tensor(q_s, device=union.device), union, k)
    t_d = torch.sqrt(t_d2).cpu().numpy()
    t_i = t_i.cpu().numpy()
    total = 0.0
    for i in range(len(picks)):           # the sentinel's running sum, in order
        total += recall_at_k(g_s[i:i + 1], t_i[i:i + 1], k, approx_dist=d_s[i:i + 1],
                             exact_dist=t_d[i:i + 1])
    if total / len(picks) != snap["online_recall"]:
        raise SystemExit(f"sentinel: online recall {snap['online_recall']} != "
                         f"{total / len(picks)} against the plain Dss")
    out = {"sample_rate": rate, "recalibrate_every": 4, "queries": len(q_np),
           "audits": snap["audits"],
           "audits_in_ticks": in_ticks, "pending_after_ticks": pending,
           "drained": drained, "online_recall": snap["online_recall"],
           "last_threshold": snap["last_threshold"],
           "audit_ms_mean": span_hist.sum / span_hist.count,
           "audit_ms_p50": span_hist.quantile(0.5),
           "audit_ms_max": span_hist.quantile(1.0),
           "drain_ms_per_audit": drain_s * 1e3 / max(drained, 1),
           "tick_ms_off": float(np.mean(ticks_off)),
           "tick_ms_on": float(np.mean(ticks_on)),
           "tick_ms_on_max": float(np.max(ticks_on)),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    say("fleet sentinel: " + json.dumps(out, default=float)
        + "; answers bit-equal with the sentinel on and off; the audited "
        "queries are the seeded draws and their mean recall == recall_at_k "
        "against the plain Dss")
    return out


def net_client(port, queries, k, name, pipelined, ready, go, out) -> None:
    """One client process of the net path: connect, report ready, wait for
    ``go``, then send ``queries`` as one pipelined ``query_batch`` (resent
    whole on ``RetryLater``) or one at a time (each retried on
    ``RetryLater``).  Puts its answers, per-request round trips (what its
    ``net.rtt_ms`` histogram observes) and wall-clock window on ``out``."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serve.net import ClimberClient, RetryLater
    try:
        with ClimberClient("127.0.0.1", port, client_name=name, timeout=300) as c:
            ready.put(name)
            if not go.wait(timeout=600):
                raise TimeoutError("no go signal")
            got, rtt, refused = [], [], 0
            begin = time.time()
            for batch in ([list(queries)] if pipelined else [[q] for q in queries]):
                while True:
                    t = time.perf_counter()
                    try:
                        replies = c.query_batch(batch, k=k)
                        break
                    except RetryLater as exc:
                        refused += 1
                        time.sleep(max(exc.retry_after_ms, 1.0) / 1e3)
                rtt.append((time.perf_counter() - t) * 1e3 / len(batch))
                got += replies
            out.put({"name": name, "begin": begin, "end": time.time(),
                     "dist": np.stack([r.dist for r in got]),
                     "gid": np.stack([r.gid for r in got]),
                     "rtt_ms": rtt, "retry_later": refused})
    except Exception as exc:          # reported to the parent, which fails
        ready.put(name)
        out.put({"name": name, "error": f"{type(exc).__name__}: {exc}"})


def net_path(fleet, q_np, k, bs, report) -> dict:
    """The network plane on the fleet path's fleet (module docstring, item
    4).  The clients run in processes of their own, as a deployment's
    would.  Every hard check raises.  Returns the path's launch counts,
    read after the server stopped and before the reference answers are
    computed."""
    import multiprocessing
    import numpy as np
    import torch
    from repro_torch.fleet import FleetEngine
    from repro_torch.kernels import ops
    from repro_torch.obs import REGISTRY
    from repro_torch.obs.registry import Histogram
    from repro_torch.serve.net import ClimberClient, serve_in_thread

    out = report.setdefault("net", {})
    ctx = multiprocessing.get_context("spawn")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng = FleetEngine(fleet, batch_size=bs, k=k, routing="signature", fanout=2)
    # admission sized for the whole pipelined batch (no refusal possible)
    server, stop = serve_in_thread(eng, config=eng.config.replace(
        max_pending=len(q_np), admission_depth=len(q_np)))
    rejected0 = REGISTRY.counter("net.rejected").value
    answers, phases = {}, {}

    def run_clients(label, specs):
        """Start one process per (name, rows, pipelined), release them
        together, collect their results; every process is joined."""
        ready, go, results = ctx.Queue(), ctx.Event(), ctx.Queue()
        procs = [ctx.Process(target=net_client, daemon=True, args=(
            server.port, q_np[rows], k, name, pipe, ready, go, results))
            for name, rows, pipe in specs]
        ticks0, tick_s0, got = eng.stats.ticks, eng.stats.total_s, []
        try:
            for proc in procs:
                proc.start()
            for _ in procs:
                ready.get(timeout=300)
            go.set()
            got = [results.get(timeout=600) for _ in procs]
        finally:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
        errors = [r["error"] for r in got if "error" in r]
        if errors or len(got) != len(procs):
            raise SystemExit(f"net: {label} clients failed: {errors}")
        by_name = {r["name"]: r for r in got}
        for name, rows, _ in specs:
            for j, i in enumerate(rows):
                answers[label, int(i)] = (by_name[name]["dist"][j],
                                          by_name[name]["gid"][j])
        hist = Histogram()
        for r in got:
            for v in r["rtt_ms"]:
                hist.observe(v)
        secs = max(r["end"] for r in got) - min(r["begin"] for r in got)
        ticks = eng.stats.ticks - ticks0
        nq = sum(len(rows) for _, rows, _ in specs)
        phases[label] = {"clients": len(specs), "queries": nq, "seconds": secs,
                         "qps": nq / secs, "ticks": ticks,
                         "mean_batch_fill": nq / (ticks * bs) if ticks else 0.0,
                         "tick_ms_mean": (eng.stats.total_s - tick_s0) * 1e3 / ticks
                         if ticks else 0.0,
                         "client_rtt_ms_p50": hist.quantile(0.5),
                         "client_rtt_ms_p99": hist.quantile(0.99),
                         "client_retries": sum(r["retry_later"] for r in got)}

    try:
        idx = np.arange(len(q_np))
        run_clients("pipelined", [("smoke-pipelined", idx, True)])
        run_clients("concurrent", [(f"smoke-client{w}", idx[w::4], False)
                                   for w in range(4)])
        with ClimberClient("127.0.0.1", server.port, client_name="smoke-admin",
                           timeout=300) as c:
            page, traces, health = c.metrics(), c.traces(), c.health()
        lat = REGISTRY.histogram("serve.latency_ms", loop=eng.obs_label)
        out.update({
            "queries": 2 * len(q_np), "batch_size": bs, "max_pending": len(q_np),
            "admission_depth": len(q_np),
            "flush_interval_ms": eng.config.flush_interval_ms, "phases": phases,
            "serve_latency_ms_p50": lat.quantile(0.5),
            "serve_latency_ms_p99": lat.quantile(0.99),
            "overlap_admissions": server.overlap_admissions,
            "retry_later_replies": REGISTRY.counter("net.rejected").value - rejected0,
            "health": health, "flight_traces": len(traces),
            "metrics_page_bytes": len(page)})
    finally:
        stop()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if server._exec_thread.is_alive() or server._pending:
        raise SystemExit(f"net: server did not drain ({server._pending} pending)")
    for series in ("repro_fleet_online_recall", "repro_net_queries_total",
                   "repro_net_connections_total", "repro_net_frames_in_total"):
        if series not in page:
            raise SystemExit(f"net: the metrics page has no {series}")
    if health["ready"] != 1 or health["shards"] != len(fleet.shards):
        raise SystemExit(f"net: bad health card {health}")
    d_ref, g_ref = [], []
    for a in range(0, len(q_np), bs):
        d, g, _ = fleet.query(q_np[a:a + bs], k, routing="signature", fanout=2,
                              variant="adaptive")
        d_ref.append(d)
        g_ref.append(g)
    d_ref, g_ref = np.concatenate(d_ref), np.concatenate(g_ref)
    if len(answers) != 2 * len(q_np):
        raise SystemExit(f"net: {len(answers)} answers for {2 * len(q_np)} queries")
    for (label, i), (d, g) in answers.items():
        if not (np.array_equal(d, d_ref[i]) and np.array_equal(g, g_ref[i])):
            raise SystemExit(f"net: {label} answer {i} differs from IndexFleet.query")
    out["launches"] = launches
    say("net: " + json.dumps(out, default=float) + f"; {len(answers)} socket answers "
        "bit-equal to IndexFleet.query; the server drained and stopped")
    say(f"net-path launches: {launches}")
    missing = [name for name in FLEET_KERNELS if launches[name] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the net path: {missing}")
    out["refine_checks"] = net_refine_checks(
        fleet, torch.as_tensor(q_np[:2], device=fleet.device), k)
    return launches


def fleet_path(args, dev, cfg, report):
    """The fleet path (module docstring, item 3), then the network path on
    its fleet (item 4).  Every hard check raises.  Returns the two paths'
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.eval import perturbed_queries, recall_at_k, tenant_corpus
    from repro_torch.fleet import (FleetConfig, FleetEngine, IndexFleet,
                                   MergePolicy)
    from repro_torch.kernels import ops
    from repro_torch.serve import QueryRequest

    k, nq, bs = cfg.k, args.queries, 64
    out = report.setdefault("fleet", {})
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()

    # ---- shards: one tenant each ---------------------------------------
    t = time.perf_counter()
    corpus = tenant_corpus("seismic", num_shards=FLEET_TENANTS,
                           shard_size=args.fleet_shard, series_len=cfg.series_len,
                           seed=args.seed + 11, affinity=0.6, device=dev)
    queries = perturbed_queries(corpus, nq, noise=0.1, seed=args.seed + 11)
    warm = perturbed_queries(corpus, bs, noise=0.1, seed=args.seed + 12)
    n_ins = (INSERT_BATCHES + TAIL_BATCHES) * INSERT_ROWS
    inserts = perturbed_queries(corpus, n_ins, noise=0.1,
                                seed=args.seed + 13).cpu().numpy()
    union = corpus.union
    torch.cuda.synchronize()
    out["datagen_s"] = time.perf_counter() - t
    seal_at = INSERT_BATCHES * INSERT_ROWS // 2          # two seals under load
    fleet = IndexFleet(FleetConfig(shard_cfg=cfg, fanout=2, delta_capacity=seal_at,
                                   background_compaction=True), device=dev)
    shards = []
    for i, block in enumerate(corpus.shards):
        (h, secs) = sync_wall(lambda: fleet.add_shard(f"tenant{i}", block))
        st = h.index.store
        row = {"key": h.key, "records": h.num_records, "build_s": secs,
               "P": st.num_partitions, "cap": st.capacity,
               "store_gb": sum(x.numel() * x.element_size() for x in st) / 1e9,
               "steps_s": {a: round(b, 3) for a, b in h.index.build_seconds.items()}}
        shards.append(row)
        say(f"fleet shard[{h.key}]: " + json.dumps(
            {a: (round(b, 3) if isinstance(b, float) else b) for a, b in row.items()}))
    out["shards"] = shards
    del corpus, block, h, st
    fleet.attach_mesh([dev])
    q_np = queries.cpu().numpy()

    # stage_ms of every fleet.query call the engines make
    stage_acc = {}
    fleet_query = fleet.query

    def timed_query(*a, **kw):
        d, g, info = fleet_query(*a, **kw)
        for name, v in info.stage_ms.items():
            stage_acc[name] = stage_acc.get(name, 0.0) + v
        return d, g, info

    fleet.query = timed_query

    # ---- serving: host loop and the stacked pass ------------------------
    truth = [fleet.scan_exact(q_np[a:a + bs]) for a in range(0, nq, bs)]
    t_d, t_i = (np.concatenate(x) for x in zip(*truth))
    serve, answers = {}, {}
    for placement in ("host", "mesh"):
        eng = FleetEngine(fleet, batch_size=bs, k=k, routing="signature", fanout=2,
                          variant="adaptive", placement=placement)
        eng.run(warm.cpu().numpy())                            # warm-up tick
        row = {}
        for label in ("cold", "cached"):      # every plan new, then all cached
            eng.reset_metrics()
            stage_acc.clear()
            torch.cuda.synchronize()
            (d, g, metrics), secs = sync_wall(lambda: eng.run(q_np))
            st = eng.stats
            row[label] = {
                "tick_ms": st.total_s / st.ticks * 1e3, "qps": st.queries_per_sec,
                "stage_ms": {a: b / st.ticks for a, b in stage_acc.items()},
                "plan_cache_hit_rate": st.plan_cache_hit_rate,
                "mean_partitions_touched": st.mean_partitions_touched,
                "mean_candidates_scanned": st.mean_candidates_scanned,
                "fanout_savings": fleet.stats.fanout_savings,
                "recall_at_k": recall_at_k(g, t_i, k, approx_dist=d, exact_dist=t_d)}
            answers[placement, label] = (d, g)
        serve[placement] = row
        say(f"fleet serve[{placement}]: " + json.dumps(row, default=float))
    for label in ("cold", "cached"):
        (dh, gh), (dm, gm) = answers["host", label], answers["mesh", label]
        if not (np.array_equal(dh, dm) and np.array_equal(gh, gm)):
            raise SystemExit(f"fleet: host and mesh answers differ ({label})")
    say(f"fleet: host == mesh on {nq} queries, cold and cached (dist and gid bit-equal)")
    out["serve"] = serve

    # ---- exact fan-out ≡ scan_exact ≡ Dss --------------------------------
    q64 = queries[:bs].contiguous()
    tol = 1e-5 * ((q64.double() ** 2).sum(-1, keepdim=True) + float(
        max(float(s.index.store.norms.max()) for s in fleet.shards)))
    d_ex, g_ex, _ = fleet.query(q_np[:bs], k, routing="exhaustive", variant="exhaustive")
    sq = lambda d: torch.as_tensor(d, device=dev).double() ** 2
    gi = lambda g: torch.as_tensor(g, device=dev)
    e1, n1 = assert_same_topk("fleet exhaustive fan-out vs scan_exact", sq(d_ex), gi(g_ex),
                              sq(t_d[:bs]), gi(t_i[:bs]), tol)
    (d_ss, i_ss), dss_s = sync_wall(lambda: exact_knn(q64, union, k, chunk=SCAN_CHUNK))
    e2, n2 = assert_same_topk("fleet scan_exact vs Dss", sq(t_d[:bs]), gi(t_i[:bs]),
                              d_ss.double() ** 2, i_ss, tol)
    out["exact"] = {"fanout_vs_scan_max_abs_err": e1, "fanout_vs_scan_gid_queries": n1,
                    "scan_vs_dss_max_abs_err": e2, "scan_vs_dss_gid_queries": n2,
                    "dss_s": dss_s}
    say(f"fleet: exhaustive fan-out == scan_exact (max |Δd²| {e1:.3g}, {n1} queries "
        f"reorder at ties) == Dss (max |Δd²| {e2:.3g}, {n2} queries) on {bs} queries")
    del d_ss, i_ss

    # ---- the online recall sentinel on the same traffic ----------------
    peak_pre = torch.cuda.max_memory_allocated()       # the sentinel resets it
    out["sentinel"] = sentinel_check(fleet, union, q_np, k, bs)
    del union

    # ---- ingest under load: WAL, background seals, ticks ---------------
    (ROOT / "build").mkdir(exist_ok=True)
    storage = Path(tempfile.mkdtemp(prefix="smoke_fleet_", dir=ROOT / "build"))
    try:
        (_, attach_s) = sync_wall(lambda: fleet.attach_storage(storage))
        eng = FleetEngine(fleet, batch_size=bs, k=k, routing="signature", fanout=2,
                          variant="adaptive", placement="mesh", maintenance_every=1)
        ins_s, ticks, inflight, read_err = 0.0, [], [], 0.0
        for b in range(INSERT_BATCHES):
            rows = inserts[b * INSERT_ROWS:(b + 1) * INSERT_ROWS]
            t = time.perf_counter()
            gids = fleet.insert(rows)
            ins_s += time.perf_counter() - t
            if b >= INSERT_BATCHES - 8:       # acknowledged rows read back at once
                dr, gr, _ = fleet_query(rows[:8], k, variant="exhaustive")
                for i in range(8):
                    hit = gr[i] == gids[i]
                    q2 = float((rows[i].astype(np.float64) ** 2).sum())
                    if not hit.any() or float(dr[i][hit][0]) ** 2 > 1e-5 * 2 * q2:
                        raise SystemExit(f"fleet: acknowledged row {gids[i]} does not "
                                         f"read back at distance 0")
                    read_err = max(read_err, float(dr[i][hit][0]) ** 2)
            ticket = fleet._seal_ticket
            sealing = ticket is not None and not ticket.done()
            for i in range(bs):
                eng.submit_request(QueryRequest(series=q_np[i], k=k, request_id=i))
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step()
            ticks.append((time.perf_counter() - t) * 1e3)
            if sealing:
                inflight.append(ticks[-1])
        ticket = fleet._seal_ticket
        if ticket is not None:
            ticket.wait()
        if fleet.stats.compactions != 2 or not inflight:
            raise SystemExit(f"fleet: {fleet.stats.compactions} seals, {len(inflight)} "
                             f"ticks during a seal (expected 2 seals, some in flight)")
        ingest = {"rows": INSERT_BATCHES * INSERT_ROWS, "insert_s": ins_s,
                  "acked_rows_per_s": INSERT_BATCHES * INSERT_ROWS / ins_s,
                  "attach_storage_s": attach_s,
                  "compactions": fleet.stats.compactions,
                  "compaction_ms": fleet.stats.compaction_ms,
                  "delta_rebuilds": fleet.stats.delta_rebuilds,
                  "wal_bytes_appended": fleet.wal.appended_bytes,
                  "tick_ms_mean": float(np.mean(ticks)),
                  "tick_ms_during_seal_mean": float(np.mean(inflight)),
                  "ticks_during_seal": len(inflight),
                  "tick_ms_max": float(np.max(ticks)),
                  "readback_max_d2": read_err,
                  "plan_cache_hit_rate": eng.stats.plan_cache_hit_rate,
                  "shards": [s.key for s in fleet.shards]}
        for b in range(INSERT_BATCHES, INSERT_BATCHES + TAIL_BATCHES):    # WAL tail
            fleet.insert(inserts[b * INSERT_ROWS:(b + 1) * INSERT_ROWS])
        ingest["wal_bytes_pending"] = fleet.stats.wal_bytes
        out["ingest"] = ingest
        say("fleet ingest: " + json.dumps(ingest, default=float))

        # ---- restart: save, open into a new fleet, replay the WAL --------
        live_d, live_g, _ = fleet_query(q_np[:bs], k)
        (_, save_s) = sync_wall(lambda: fleet.save())
        (reopened, open_s) = sync_wall(lambda: IndexFleet.open(storage, device=dev))
        re_d, re_g, _ = reopened.query(q_np[:bs], k)
        if not (np.array_equal(re_d, live_d) and np.array_equal(re_g, live_g)):
            raise SystemExit("fleet: answers after restart differ from the live fleet's")
        out["restart"] = {"save_s": save_s, "open_and_replay_s": open_s,
                          "replayed_rows": reopened.delta.occupancy,
                          "shards": len(reopened.shards)}
        say(f"fleet restart: save {save_s:.2f} s, open + WAL replay "
            f"({reopened.delta.occupancy} rows) {open_s:.2f} s; {bs} answers bit-equal")
        del reopened

        # ---- merge the two sealed delta shards ---------------------------
        pre_d, pre_g, _ = fleet_query(q_np[:bs], k, routing="exhaustive",
                                      variant="exhaustive")
        rep_m, merge_s = sync_wall(lambda: fleet.maintenance(MergePolicy(
            small_shard_records=seal_at, max_merged_records=2 * seal_at)))
        if len(rep_m["merged"]) != 1:
            raise SystemExit(f"fleet: maintenance merged {rep_m['merged']}")
        post_d, post_g, _ = fleet_query(q_np[:bs], k, routing="exhaustive",
                                        variant="exhaustive")
        sc_d, sc_g = fleet.scan_exact(q_np[:bs])
        e3, n3 = assert_same_topk("fleet after merge vs scan_exact", sq(post_d),
                                  gi(post_g), sq(sc_d), gi(sc_g), tol)
        e4, n4 = assert_same_topk("fleet after merge vs before", sq(post_d), gi(post_g),
                                  sq(pre_d), gi(pre_g), tol)
        out["merge"] = {"seconds": merge_s, "merged": rep_m["merged"],
                        "shards": [s.key for s in fleet.shards],
                        "vs_scan_max_abs_err": e3, "vs_before_max_abs_err": e4,
                        "vs_before_gid_queries": n4}
        say(f"fleet merge: {rep_m['merged']} in {merge_s:.2f} s; exhaustive answers "
            f"== scan_exact (max |Δd²| {e3:.3g}) and == before the merge "
            f"({n4} queries reorder at ties)")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        out["launches"] = launches
        out["seconds"] = time.perf_counter() - t_path
        out["peak_memory_gb"] = max(peak_pre, torch.cuda.max_memory_allocated()) / 1e9
        say(f"fleet-path launches: {launches} ({out['seconds']:.1f} s, peak device "
            f"memory {out['peak_memory_gb']:.1f} GB)")
        missing = [name for name in FLEET_KERNELS if launches[name] <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on the fleet path: {missing}")
        out["refine_checks"] = fleet_refine_checks(fleet, q64, k)
        out["peak_memory_gb_with_checks"] = max(
            peak_pre, torch.cuda.max_memory_allocated()) / 1e9
        fleet.query = fleet_query
        net_launches = net_path(fleet, q_np, k, bs, report)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    return launches, net_launches


def frontier_path(args, dev, cfg, report) -> dict:
    """The recall frontier (module docstring, item 5): ``run_frontier`` at
    ``ClimberConfig()`` over two datasets at 1 and 4 shards, then its hard
    checks, the last of which re-answers the seismic × 4 sweep's queries
    through a fresh evaluation fleet with exhaustive routing and the
    exhaustive planner against Dss through the plain ``pairwise_l2``, and
    holds both kernels the sweep's queries and ground truth ran through
    against their plain versions at the sweep's shapes.  Every hard check
    raises.  Returns the path's launch counts (read before those checks)."""
    import dataclasses
    import inspect
    import numpy as np
    import torch
    from repro_torch.core.query import register_recall_target
    from repro_torch.eval import (FrontierSpec, GroundTruthCache, build_eval_fleet,
                                  perturbed_queries, tenant_corpus)
    from repro_torch.kernels import ops

    class SmokeFrontierSpec(FrontierSpec):
        """The sweep at the paper's configuration: every shard is
        ``ClimberConfig()`` (the package's spec keeps the JAX package's
        small shard config)."""

        def shard_cfg(self):
            return cfg

    spec = SmokeFrontierSpec(
        datasets=("randomwalk", "seismic"), shard_counts=(1, 4),
        shard_size=args.frontier_shard, series_len=cfg.series_len,
        num_queries=EVAL_QUERIES, num_calibration=32, k=cfg.k, seed=args.seed)
    out = report.setdefault("frontier", {"spec": dataclasses.asdict(spec)})
    (ROOT / "build").mkdir(exist_ok=True)
    gt_dir = Path(tempfile.mkdtemp(prefix="smoke_frontier_gt_", dir=ROOT / "build"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        from repro_torch.eval import run_frontier
        t = time.perf_counter()
        doc = run_frontier(spec, cache_dir=gt_dir, device=dev,
                           progress=lambda m: say(f"frontier: {m} "
                                                  f"({time.perf_counter() - t:.1f} s)"))
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        out["seconds"] = time.perf_counter() - t
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["ground_truth_cache"] = doc["ground_truth_cache"]
        cells = doc["cells"]
        out["cells"], out["frontiers"], out["routed_gap"] = \
            cells, doc["frontiers"], doc["routed_gap"]
        say(f"frontier-path launches: {launches} ({out['seconds']:.1f} s, peak "
            f"device memory {out['peak_memory_gb']:.1f} GB)")
        missing = [name for name in FLEET_KERNELS + ("pairwise_l2",)
                   if launches[name] <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on the frontier path: {missing}")

        # ---- report: per dataset and shard count -------------------------
        for ds in spec.datasets:
            for shards in spec.shard_counts:
                total = shards * spec.shard_size
                mine = [c for c in cells if c.get("dataset") == ds
                        and c.get("shards") == shards and "recall" in c]
                row = {"learned": [c["param"] for c in mine
                                   if c["param"].startswith("learned=")][:1],
                       "spend": {c["param"]: {"recall": c["recall"],
                                              "frac_scanned": c["mean_candidates_scanned"]
                                              / total,
                                              "partitions": c["mean_partitions_touched"]}
                                 for c in mine if c["variant"] == "recall_target"
                                 and c["split"] == "all"},
                       "slot_budget": {c["slot_budget"]: {
                           "recall": c["recall"],
                           "partitions": c["mean_partitions_touched"]}
                           for c in mine if c["slot_budget"] and c["split"] == "all"},
                       "exhaustive_routing_recall": {
                           c["split"]: c["recall"] for c in mine
                           if c["routing"] == "exhaustive" and c["param"] == "-"
                           and not c["slot_budget"]},
                       "auc": {f["split"]: {"fixed": f["fixed_auc"],
                                            "adaptive": f["adaptive_auc"]}
                               for f in doc["frontiers"] if f["dataset"] == ds
                               and f["shards"] == shards},
                       "routed_gap": [
                           {a: g[a] for a in ("split", "param", "frac_scanned",
                                              "adaptive_recall", "fixed_recall_at_cost",
                                              "improvement")}
                           for g in doc["routed_gap"] if g["dataset"] == ds
                           and g["shards"] == shards and g["split"] == "all"]}
                say(f"frontier[{ds} x {shards}]: " + json.dumps(row, default=float))

        # ---- hard checks on the cells --------------------------------------
        for c in cells:
            if "recall" not in c:
                continue
            if not (0.0 <= c["recall"] <= 1.0 and np.isfinite(c["map"])):
                raise SystemExit(f"frontier: malformed cell {c}")
            if c["slot_budget"] and \
                    c["mean_partitions_touched"] > c["slot_budget"] * c["shards"]:
                raise SystemExit(f"frontier: slot budget {c['slot_budget']} touched "
                                 f"{c['mean_partitions_touched']} partitions")
        for exh in (c for c in cells if c.get("routing") == "exhaustive"
                    and c.get("param") == "-" and c.get("slot_budget") == 0):
            routed = [c for c in cells if "routing" in c and c["routing"] != "exhaustive"
                      and (c["dataset"], c["shards"], c["split"])
                      == (exh["dataset"], exh["shards"], exh["split"])]
            over = [c for c in routed
                    if c["mean_candidates_scanned"] > exh["mean_candidates_scanned"]]
            if over:
                raise SystemExit(f"frontier: routed cells scan more than exhaustive "
                                 f"routing: {over}")
        say("frontier: exhaustive routing scans at least as much as every routed "
            "cell; every slot budget b keeps to at most b x shards partitions")

        # ---- the exhaustive ceiling ≡ the plain Dss ------------------------
        # seismic x 4 again, outside the counts: its first Dss chunk through
        # pairwise_l2 and its plain version, the sweep's cached ground truth
        # and a fresh fleet's exhaustive answers against Dss through the
        # plain pairwise_l2, and refine_topk against its plain version on
        # shard 0's exhaustive and spend-4 plans
        ds, shards, k = "seismic", 4, spec.k
        corpus = tenant_corpus(ds, num_shards=shards, shard_size=spec.shard_size,
                               series_len=spec.series_len, seed=spec.seed,
                               affinity=spec.affinity, device=dev)
        qs = perturbed_queries(corpus, spec.num_queries, noise=spec.noise,
                               seed=spec.seed)
        meta = dict(corpus.meta(), num_queries=spec.num_queries, noise=spec.noise,
                    qseed=spec.seed)
        cached = GroundTruthCache(gt_dir).get(dict(meta, k=2 * k))
        if cached is None:
            raise SystemExit("frontier: the sweep's ground truth is not in its cache")
        union = corpus.union
        # the rows of one Dss launch of the sweep's ground truth
        chunk = union[:inspect.signature(GroundTruthCache.exact).parameters["chunk"].default]
        l2_err = l2_check("pairwise_l2 [frontier Dss chunk]", qs, chunk)
        out["l2_check"] = {"shape": f"[{qs.shape[0]},{qs.shape[1]}] x "
                                    f"[{chunk.shape[0]},{chunk.shape[1]}]",
                           "max_abs_err": l2_err}
        say(f"pairwise_l2 [frontier Dss chunk]: max |Δd²| {l2_err:.3g} over "
            f"{out['l2_check']['shape']}")
        p_d2, p_i = plain_exact_knn(qs, union, 2 * k)
        tol = 1e-5 * ((qs.double() ** 2).sum(-1, keepdim=True)
                      + float((union * union).sum(-1).max()))
        del union, chunk
        fleet = build_eval_fleet(corpus, spec, device=dev)
        del corpus
        sq = lambda d: torch.as_tensor(d, device=dev).double() ** 2
        gi = lambda g: torch.as_tensor(g, device=dev)
        gt_err, gt_tie = assert_same_topk("frontier cached Dss vs plain Dss",
                                          sq(cached[0]), gi(cached[1]),
                                          p_d2.double(), p_i, tol)
        q_np = qs.cpu().numpy()
        d_ex, g_ex, info = fleet.query(q_np, k, routing="exhaustive",
                                       variant="exhaustive")
        err, n_tie = assert_same_topk("frontier exhaustive ceiling vs plain Dss",
                                      sq(d_ex), gi(g_ex), p_d2[:, :k].double(),
                                      p_i[:, :k], tol)
        _, _, info_a = fleet.query(q_np, k, routing="exhaustive")
        exh_all = next(c for c in cells if (c.get("dataset"), c.get("shards"),
                                           c.get("split"), c.get("routing"),
                                           c.get("param"), c.get("slot_budget"))
                       == (ds, shards, "all", "exhaustive", "-", 0))
        if float(info_a.candidates_scanned.mean()) != exh_all["mean_candidates_scanned"]:
            raise SystemExit("frontier: a fresh fleet scans differently from the sweep's")
        out["exhaustive_ceiling"] = {"max_abs_err": err, "gid_queries_differ": n_tie,
                                     "cached_gt_max_abs_err": gt_err,
                                     "cached_gt_gid_queries_differ": gt_tie,
                                     "candidates_scanned": float(
                                         info.candidates_scanned.mean())}
        say(f"frontier: seismic x 4, the sweep's cached Dss (2k = {2 * k}) == Dss "
            f"through the plain pairwise_l2 (max |Δd²| {gt_err:.3g}, {gt_tie} queries "
            f"reorder at ties); exhaustive routing + exhaustive planner == the plain "
            f"Dss (max |Δd²| {err:.3g}, {n_tie} of {len(q_np)} queries reorder at "
            f"k-th-distance ties); a fresh fleet scans as the sweep did")
        del p_d2, p_i
        h = fleet.shards[0]
        register_recall_target(4.0)
        out["refine_checks"] = refine_plan_checks("frontier", qs, k, [
            (f"{label}, shard {h.key}", h.index.store, host_plan(h.index, qs, variant))
            for label, variant in (("exhaustive", "exhaustive"),
                                   ("spend 4", "recall_target"))])
        del fleet
    finally:
        shutil.rmtree(gt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num", type=int, default=4_194_304,
                    help="series in the dataset (the paper's scale, cut to one card)")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--other-num", type=int, default=1_048_576,
                    help="series in each of the sift/dna/eeg/seismic datasets")
    ap.add_argument("--tenant-shard", type=int, default=262_144,
                    help="series in each of the tenant corpus's 4 shards")
    ap.add_argument("--fleet-shard", type=int, default=1_048_576,
                    help="series in each of the fleet's 4 tenant shards")
    ap.add_argument("--frontier-shard", type=int, default=1_048_576,
                    help="series in each shard of the recall-frontier sweep")
    ap.add_argument("--report", default=None,
                    help="also write the full JSON report to this path")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np
    from repro_torch.core.query import (knn_query, plan as plan_queries,
                                        register_recall_target)
    from repro_torch.core.index import build_index
    from repro_torch.core.refine import refine
    from repro_torch.data import make_dataset, make_queries
    from repro_torch.eval import (GroundTruthCache, hardness_split,
                                  mean_average_precision, perturbed_queries,
                                  recall_at_k, tenant_corpus)
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels.l2 import pairwise_l2_plain, qdots_plain
    from repro_torch.kernels.paa_kernel import paa_plain
    from repro_torch.kernels.pivot_rank import pivot_distances_plain, pivot_rank_plain
    from repro_torch.kernels.refine_topk import (masked_distances, refine_topk,
                                                 refine_work, topk_flat)
    from repro_torch.serve import ClimberEngine
    from repro_torch.utils.config import ClimberConfig

    dev = torch.device("cuda", 0)
    report = {"args": vars(args)}

    # ---- card + kernel build -------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say(f"card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t
    ptxas = ptxas_table(_lib.build_log())
    say(f"kernels: built/loaded libclimber_kernels.so in {build_s:.1f} s")
    for entry, v in ptxas.items():
        say(f"  ptxas {entry}: {v}")
    report["kernel_build_s"] = build_s
    report["ptxas"] = ptxas

    # ---- main path: data → build → serve, launch counts zeroed ----------
    cfg = ClimberConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = time.perf_counter()
    data = make_dataset("randomwalk", args.num, cfg.series_len, generator=gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t

    ops.reset_launch_counts()
    index = build_index(data, cfg, device=dev, generator=gen)
    store = index.store
    store_gb = sum(x.numel() * x.element_size() for x in store) / 1e9
    bs = {k: round(v, 3) for k, v in index.build_seconds.items()}
    say(f"build: N={args.num} n={cfg.series_len} P={store.num_partitions} "
        f"cap={store.capacity} G={index.num_groups} "
        f"trie_nodes={index.forest.num_nodes} store_gb={store_gb:.3f} "
        f"raw_gb={data.numel() * 4 / 1e9:.3f} datagen_s={gen_s:.2f} steps_s={bs}")
    report["build"] = {"N": args.num, "P": store.num_partitions,
                       "cap": store.capacity, "G": index.num_groups,
                       "trie_nodes": index.forest.num_nodes,
                       "store_gb": store_gb, "seconds": index.build_seconds,
                       "datagen_s": gen_s}

    queries = make_queries(data, args.queries, generator=gen)
    serve = {}
    engines = {}
    for variant, nq in (("adaptive", args.queries), ("knn", 64),
                        ("od_smallest", 64)):
        eng = ClimberEngine(index, batch_size=64, variant=variant, k=cfg.k)
        eng.run(queries[:64].cpu().numpy())          # warm-up tick
        eng.reset_metrics()
        dist, gid, _ = eng.run(queries[:nq].cpu().numpy())
        st = eng.stats
        row = {"queries": st.queries, "ticks": st.ticks,
               "qps": st.queries_per_sec,
               "featurize_ms": st.featurize_s / st.ticks * 1e3,
               "plan_ms": st.plan_s / st.ticks * 1e3,
               "refine_ms": st.refine_s / st.ticks * 1e3,
               "tick_ms": st.total_s / st.ticks * 1e3,
               "mean_partitions_touched": st.mean_partitions_touched,
               "mean_candidates_scanned": st.mean_candidates_scanned}
        serve[variant] = row
        engines[variant] = (eng, dist, gid)
        say(f"serve[{variant}]: " + json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()}))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    say(f"serve-path launches: {launches}")
    report["serve"] = serve
    report["launches_serve"] = launches
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the serve path: {missing}")

    # ---- where one serving tick's time goes (a separate, traced tick) -----
    from torch.profiler import ProfilerActivity, profile
    eng_p = ClimberEngine(index, batch_size=64, variant="adaptive", k=cfg.k)
    eng_p.run(queries[:64].cpu().numpy())                # warm-up, fills its cache
    qb = queries[64:128].cpu().numpy()                   # not cached: a full tick
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng_p.run(qb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time is
    # its kernels' time again
    dev_ms, dev_calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms[e.name] = dev_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            dev_calls[e.name] = dev_calls.get(e.name, 0) + 1
    dev_rows = sorted(((n, ms, dev_calls[n]) for n, ms in dev_ms.items()),
                      key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in dev_rows)
    prof_report = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                   "device_kernel_kinds": len(dev_rows),
                   "top": [{"name": n[:80], "ms": ms, "calls": c}
                           for n, ms, c in dev_rows[:12]]}
    if dev_rows:
        prof_report["idle_share"] = 1.0 - busy_ms / wall_ms
        say(f"profile (one adaptive tick of 64, traced): wall {wall_ms:.3f} ms, "
            f"device busy {busy_ms:.3f} ms over {len(dev_rows)} kernel kinds, idle share "
            f"{prof_report['idle_share']:.3f}; top: "
            + "; ".join(f"{n[:40]} {ms:.3f} ms x{c}" for n, ms, c in dev_rows[:5]))
    else:
        say("profile: the profiler reported no device time (idle share not measured)")
    report["profile_tick"] = prof_report

    # ---- answers: engine ≡ per-query knn_query; finite, right shape ------
    eng, dist, gid = engines["adaptive"]
    if dist.shape != (args.queries, cfg.k) or not np.isfinite(dist).all():
        raise SystemExit(f"engine answers malformed: {dist.shape}")
    for i in range(8):
        d1, g1, _ = knn_query(index, queries[i:i + 1], cfg.k, variant="adaptive")
        if not (np.array_equal(g1.cpu().numpy()[0], gid[i])
                and np.array_equal(d1.cpu().numpy()[0], dist[i])):
            raise SystemExit(f"engine answer {i} differs from knn_query")
    say("engine == per-query knn_query on 8 queries (dist and gid bit-equal)")

    # ---- evaluation path (Fig. 7), launch counts zeroed ------------------
    register_recall_target(2.0)          # the "recall_target" variant, spend 2
    (ROOT / "build").mkdir(exist_ok=True)
    gt_dir = Path(tempfile.mkdtemp(prefix="smoke_gt_", dir=ROOT / "build"))
    q64 = queries[:EVAL_QUERIES].contiguous()
    fig7 = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_eval = time.perf_counter()
    try:
        gt_cache = GroundTruthCache(gt_dir)
        rows, (gt_d, gt_i) = evaluate_dataset(
            "randomwalk", data, q64, index, gt_cache,
            {"name": "randomwalk", "seed": args.seed, "series_len": cfg.series_len},
            cfg, gen)
        fig7 += rows
        for j, name in enumerate(("sift", "dna", "eeg", "seismic")):
            g_o = torch.Generator(device=dev).manual_seed(args.seed + 1 + j)
            t = time.perf_counter()
            x_o = make_dataset(name, args.other_num, cfg.series_len, generator=g_o)
            q_o = make_queries(x_o, EVAL_QUERIES, generator=g_o).contiguous()
            idx_o = build_index(x_o, cfg, device=dev, generator=g_o)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            say(f"dataset[{name}]: N={args.other_num} (cut from the paper's "
                f"10^8-10^9 to one card) generated and CLIMBER-indexed in {secs:.2f} s: "
                f"P={idx_o.store.num_partitions} cap={idx_o.store.capacity} "
                f"store_gb={idx_o.store.data.numel() * 4 / 1e9:.3f} "
                f"steps_s={ {a: round(b, 3) for a, b in idx_o.build_seconds.items()} }")
            rows, _ = evaluate_dataset(
                name, x_o, q_o, idx_o, gt_cache,
                {"name": name, "seed": args.seed + 1 + j, "series_len": cfg.series_len},
                cfg, g_o)
            fig7 += rows
            del x_o, q_o, idx_o
            torch.cuda.empty_cache()

        # a tenant corpus: perturbed queries, 2K true neighbours, hard/easy
        shards = 4
        t = time.perf_counter()
        corpus = tenant_corpus("seismic", num_shards=shards,
                               shard_size=args.tenant_shard,
                               series_len=cfg.series_len, seed=args.seed,
                               affinity=0.6, device=dev)
        tq = perturbed_queries(corpus, EVAL_QUERIES, noise=0.1, seed=args.seed)
        union = corpus.union
        t_meta = dict(corpus.meta(), queries={"num": EVAL_QUERIES, "noise": 0.1,
                                              "seed": args.seed})
        t_d, t_i = gt_cache.exact(t_meta, tq, union, 2 * cfg.k, chunk=SCAN_CHUNK)
        hard, easy = hardness_split(t_d, cfg.k)
        g_t = torch.Generator(device=dev).manual_seed(args.seed + 9)
        t_index = build_index(union, cfg, device=dev, generator=g_t)
        d_t, gid_t, _ = knn_query(t_index, tq, cfg.k, variant="adaptive")
        d_t, gid_t = d_t.cpu().numpy(), gid_t.cpu().numpy()
        tenant = {"shards": shards, "shard_size": args.tenant_shard,
                  "affinity": 0.6, "noise": 0.1, "seconds": time.perf_counter() - t}
        for half, sel in (("hard", hard), ("easy", easy), ("all", np.arange(EVAL_QUERIES))):
            tenant[f"recall_{half}"] = recall_at_k(
                gid_t[sel], t_i[sel, :cfg.k], cfg.k, approx_dist=d_t[sel],
                exact_dist=t_d[sel, :cfg.k])
            tenant[f"map_{half}"] = mean_average_precision(gid_t[sel], t_i[sel, :cfg.k], cfg.k)
        tenant["contrast_median"] = float(np.median(t_d[:, 2 * cfg.k - 1]
                                                    / np.maximum(t_d[:, cfg.k - 1], 1e-12)))
        say(f"tenant[seismic x{shards}, {args.tenant_shard} each, affinity 0.6, "
            f"noise 0.1]: " + json.dumps({a: (round(b, 4) if isinstance(b, float) else b)
                                          for a, b in tenant.items()}))
        del corpus, union, t_index
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(gt_dir, ignore_errors=True)
    eval_launches = ops.launch_counts()
    eval_s = time.perf_counter() - t_eval
    say(f"eval-path launches: {eval_launches} ({eval_s:.1f} s)")
    report["fig7"] = fig7
    report["tenant"] = tenant
    report["launches_eval"] = eval_launches
    report["eval_seconds"] = eval_s
    missing = [k for k, v in eval_launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the evaluation path: {missing}")
    torch.cuda.empty_cache()

    # the exhaustive plan through the same kernel must give the Dss answer,
    # up to ties at the k-th distance
    exact = gt_i
    kth = gt_d[:, -1].astype(np.float64) ** 2
    q2 = (q64 * q64).sum(-1, keepdim=True)
    d_ex, g_ex, _ = knn_query(index, q64, cfg.k, variant="exhaustive")
    d2_ex = (d_ex.double() ** 2).cpu().numpy()
    g_ex = g_ex.cpu().numpy()
    tol_ex = 1e-5 * (q2[:, 0].double().cpu().numpy() + float(store.norms.max()))
    hits = 0
    for i in range(EVAL_QUERIES):
        extra = ~np.isin(g_ex[i], exact[i])
        hits += cfg.k - int(extra.sum())
        if (np.abs(d2_ex[i][extra] - kth[i]) > tol_ex[i]).any():
            raise SystemExit(f"exhaustive query {i} misses the Dss answer")
    say(f"recall@{cfg.k} (exhaustive through refine_topk vs Dss, {EVAL_QUERIES} "
        f"queries): {hits / (EVAL_QUERIES * cfg.k):.4f} (misses only at "
        f"k-th-distance ties)")
    report["recall_at_k_exhaustive"] = hits / (EVAL_QUERIES * cfg.k)

    # ---- kernels vs plain versions, at the main path's shapes -----------
    def cuda_ms(fn, iters=5, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, kernel, iters=20):
        """Mean device time of the kernels named ``*kernel*`` per call of
        ``fn``, from a profiler trace: at a small shape the event timing
        above is the host's launch cost, not the kernel's."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in pr.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name)
        return us / 1e3 / iters if us else None

    def ptxas_of(kernel):
        return {e: v for e, v in ptxas.items() if kernel in e}

    kernels = []
    w, n, r, m, k = cfg.paa_segments, cfg.series_len, cfg.num_pivots, cfg.prefix_len, cfg.k
    B = args.num

    # paa at the build's step-4 width (the whole dataset in one call)
    z_k = ops.paa(data, w)
    z_p = paa_plain(data, w)
    err = float((z_k - z_p).abs().max())
    if not err <= 1e-5:
        raise SystemExit(f"paa: kernel vs plain max abs err {err} > 1e-5")
    nbytes = B * n * 4 + B * w * 4
    bms, bby = bound_ms(nbytes, B * n)
    kernels.append({
        "name": "paa", "route": "cuda", "source": "src/repro_torch/csrc/paa.cu",
        "replaces": "src/repro/kernels/paa_kernel.py:42",
        "launches": launches["paa"], "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.paa(data, w)),
        "plain_ms": cuda_ms(lambda: paa_plain(data, w)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: data.view(B, w, n // w).mean(-1)),
        "shape": f"[{B},{n}] -> [{B},{w}]"})
    del z_p

    # pivot_rank over the dataset's PAA rows (step 4's work in one call)
    piv = index.pivots

    def check_pivot_rank(z):
        """Kernel vs plain: rows may differ only at near-ties, within a
        distance gap of 1e-5·(‖x‖²+‖p‖²).  Returns (rows differing, gap)."""
        s_k = ops.pivot_rank(z, piv, m)
        s_p = pivot_rank_plain(z, piv, m)
        bad = (s_k != s_p).any(dim=1).nonzero()[:, 0]
        gap = 0.0
        if bad.numel():
            zb = z[bad].double()
            d64 = ((zb[:, None, :] - piv.double()[None]) ** 2).sum(-1)   # exact
            dk = torch.gather(d64, 1, s_k[bad].long())
            dp = torch.gather(d64, 1, s_p[bad].long())
            gap = float((dk - dp).abs().max())
            tol = 1e-5 * float((zb * zb).sum(-1).max() + (piv * piv).sum(-1).max())
            if gap > tol:
                raise SystemExit(f"pivot_rank: {bad.numel()} rows differ with a "
                                 f"distance gap {gap} > {tol}")
        say(f"pivot_rank: {bad.numel()} of {z.shape[0]} rows differ from the plain "
            f"version, all within a distance gap of {gap:.3g}")
        return int(bad.numel()), gap

    bad, gap = check_pivot_rank(z_k)

    def pivot_rank_bound(rows):
        return bound_ms(rows * w * 4 + r * w * 4 + rows * m * 4, rows * r * (2 * w + 3))

    def library_rank(z):       # timed only: torch.topk's tie order is not lax.top_k's
        return torch.topk(pivot_distances_plain(z, piv), m, dim=-1, largest=False,
                          sorted=True)

    bms, bby = pivot_rank_bound(B)
    kernels.append({
        "name": "pivot_rank", "route": "cuda",
        "source": "src/repro_torch/csrc/pivot_rank.cu",
        "replaces": "src/repro/kernels/pivot_rank.py:59",
        "launches": launches["pivot_rank"], "max_abs_err": gap,
        "ms": cuda_ms(lambda: ops.pivot_rank(z_k, piv, m)),
        "plain_ms": cuda_ms(lambda: pivot_rank_plain(z_k, piv, m), iters=2, warmup=1),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: library_rank(z_k), iters=2, warmup=1),
        "library_call": "torch.topk(pivot_distances_plain(z, piv), m, largest=False), "
                        "TF32 off",
        "rows_differing": bad,
        "shape": f"[{B},{w}] x [{r},{w}] -> [{B},{m}]",
        "ptxas": ptxas_of(f"pivot_rank_kernel<{w},")})
    del z_k
    # and at the serving shape: one tick's featurize, 64 query rows
    z64 = ops.paa(q64, w)
    bad64, gap64 = check_pivot_rank(z64)
    bms, bby = pivot_rank_bound(64)
    kernels[-1]["serve_shape"] = {
        "rows_differing": bad64, "max_abs_err": gap64,
        "shape": f"[64,{w}] x [{r},{w}] -> [64,{m}]",
        "ms": cuda_ms(lambda: ops.pivot_rank(z64, piv, m), iters=50, warmup=5),
        "device_ms": device_ms(lambda: ops.pivot_rank(z64, piv, m), "pivot_rank"),
        "plain_ms": cuda_ms(lambda: pivot_rank_plain(z64, piv, m), iters=50, warmup=5),
        "library_ms": cuda_ms(lambda: library_rank(z64), iters=50, warmup=5),
        "bound_ms": bms, "bound_by": bby}
    say(f"pivot_rank at [64,{w}]: {json.dumps(kernels[-1]['serve_shape'])}")

    # refine_topk on three plans: one serving tick (queries 0-63, adaptive),
    # the traced tick's batch (64-127) and od_smallest (0-63), each sorted by
    # partition at its full width and held against the plain version on the
    # plan compacted to its live width (pads sort first, so the last columns
    # hold every live entry in the same relative order)
    cap = store.capacity

    def refine_plan(qs, variant):
        p4r, _ = index.featurize(qs)
        qp = plan_queries(index, p4r, variant=variant)
        order = torch.argsort(qp.sel_part, dim=-1, stable=True)
        sp, lo_, hi_ = (torch.gather(t_, 1, order).contiguous()
                        for t_ in (qp.sel_part, qp.sel_lo, qp.sel_hi))
        live_w = int((sp >= 0).sum(1).max())
        return sp, lo_, hi_, live_w

    def plain_refine(qs, sp, lo_, hi_, live_w):
        qc = max(1, int(2e9 // (live_w * cap * n * 4)))
        outs = [topk_flat(*masked_distances(
            store.data, store.norms, store.rec_dfs, store.rec_gid, qs[a:a + qc],
            sp[a:a + qc, -live_w:], lo_[a:a + qc, -live_w:], hi_[a:a + qc, -live_w:]), k)
            for a in range(0, qs.shape[0], qc)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    xmax = float(store.norms.max())
    rt_plans, rt_err = {}, 0.0
    for label, qs, variant in (("adaptive q0-63", q64, "adaptive"),
                               ("adaptive q64-127 (traced tick)",
                                queries[64:128].contiguous(), "adaptive"),
                               ("od_smallest q0-63", q64, "od_smallest")):
        sp, lo_, hi_, live_w = refine_plan(qs, variant)
        d2_k, g_k = refine_topk(store.data, store.norms, store.rec_dfs,
                                store.rec_gid, qs, sp, lo_, hi_, k)
        d2_p, g_p = plain_refine(qs, sp, lo_, hi_, live_w)
        tol = 1e-5 * ((qs * qs).sum(-1, keepdim=True) + xmax)
        err, differ = assert_same_topk(f"refine_topk [{label}]", d2_k, g_k, d2_p, g_p, tol)
        rt_err = max(rt_err, err)
        del d2_p, g_p
        work = refine_work(store.rec_dfs, store.rec_gid, sp[:, -live_w:],
                           lo_[:, -live_w:], hi_[:, -live_w:])
        mp = sp.shape[1]
        nbytes = (work["unique_kept_records"] * (4 * n + 4) + work["live_slots"] * 8
                  + qs.shape[0] * n * 4 + 3 * qs.shape[0] * mp * 4 + qs.shape[0] * k * 8)
        bms, bby = bound_ms(nbytes, work["kept_pairs"] * (2 * n + 3))
        rt_plans[label] = dict(
            work, mp=mp, live_width=live_w, max_abs_err=err, gid_queries_differ=differ,
            ms=cuda_ms(lambda: refine_topk(store.data, store.norms, store.rec_dfs,
                                           store.rec_gid, qs, sp, lo_, hi_, k)),
            device_ms=device_ms(lambda: refine_topk(store.data, store.norms, store.rec_dfs,
                                                    store.rec_gid, qs, sp, lo_, hi_, k),
                                "refine", iters=5),
            bound_ms=bms, bound_by=bby)
        say(f"refine_topk [{label}]: max |Δd²| {err:.3g}; {differ} of {qs.shape[0]} "
            f"queries differ in gid order at near-ties; " + json.dumps(
                {a: (round(b, 4) if isinstance(b, float) else b)
                 for a, b in rt_plans[label].items()}))
        if label.startswith("adaptive q0-63"):
            main_plan = (sp, lo_, hi_, live_w)
    sp, lo_, hi_, live_w = main_plan
    spc, loc, hic = sp[:, -live_w:], lo_[:, -live_w:], hi_[:, -live_w:]
    qc = max(1, int(2e9 // (live_w * cap * n * 4)))
    q2v = (q64 * q64).sum(-1, keepdim=True)
    main = rt_plans["adaptive q0-63"]
    kernels.append({
        "name": "refine_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/refine_topk.cu",
        "replaces": "src/repro/kernels/refine_topk.py:189",
        "launches": launches["refine_topk"], "max_abs_err": rt_err,
        "ms": main["ms"],
        "plain_ms": cuda_ms(lambda: plain_refine(q64, sp, lo_, hi_, live_w),
                            iters=2, warmup=1),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "kept_pairs": main["kept_pairs"],
        "unique_kept_records": main["unique_kept_records"],
        "shape": f"Q=64 MP={sp.shape[1]} (live {live_w}) cap={cap} n={n} k={k}",
        "plans": rt_plans,
        "ptxas": ptxas_of("refine_")})

    for row in kernels:
        row["path"] = "serve"

    # pairwise_l2 on one Dss chunk: 64 queries x 2^20 series
    x_c = data[:SCAN_CHUNK]
    c_n = x_c.shape[0]
    l2_err = l2_check("pairwise_l2", q64, x_c)
    say(f"pairwise_l2: max |Δd²| {l2_err:.3g} over [64, {c_n}] (n={n})")
    bms, bby = bound_ms(4 * (c_n * n + 64 * n + 64 * c_n), 2 * 64 * c_n * n)
    kernels.append({
        "name": "pairwise_l2", "route": "cuda", "source": "src/repro_torch/csrc/l2.cu",
        "replaces": "src/repro/kernels/l2.py:60", "path": "eval",
        "launches": eval_launches["pairwise_l2"], "max_abs_err": l2_err,
        "ms": cuda_ms(lambda: ops.pairwise_l2(q64, x_c)),
        "plain_ms": cuda_ms(lambda: pairwise_l2_plain(q64, x_c)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: ((q64 * q64).sum(-1, keepdim=True)
                                       - 2 * (q64 @ x_c.T)
                                       + (x_c * x_c).sum(-1)[None, :]).clamp_min(0)),
        "library_call": "(q2 - 2*(q @ x.T) + x2).clamp_min(0), TF32 off",
        "shape": f"[64,{n}] x [{c_n},{n}] -> [64,{c_n}]",
        "ptxas": ptxas_of("pairwise_l2_kernel")})

    # qdots on the rows of the adaptive plan above, compacted to its live
    # width, for the first qc queries (about 2 GB of rows)
    pid = spc[:qc].clamp(min=0).long()
    q_r = pid.shape[0]
    rows_q = store.data[pid].reshape(q_r, live_w * cap, n)
    qq = q64[:q_r].contiguous()
    o_k = ops.qdots(qq, rows_q)
    o_p = qdots_plain(qq, rows_q)
    tol = 1e-5 * (q2v[:q_r] + store.norms[pid].reshape(q_r, -1))
    qd_err = (o_k - o_p).abs()
    if bool((qd_err > tol).any()):
        raise SystemExit(f"qdots: |Δ| {float(qd_err.max())} exceeds 1e-5·(‖q‖²+‖x‖²)")
    qd_err = float(qd_err.max())
    del o_k, o_p, tol
    # and the dense refine on the card (qdots) against the fused kernel
    (d_dn, g_dn), dense_s = sync_wall(lambda: refine(store, q64, spc, loc, hic, k,
                                                     use_kernel=False))
    (d_fu, g_fu), fused_s = sync_wall(lambda: refine(store, q64, spc, loc, hic, k,
                                                     use_kernel=True))
    dn_err, dn_differ = assert_same_topk("dense refine (qdots) vs fused",
                                         d_dn.double() ** 2, g_dn,
                                         d_fu.double() ** 2, g_fu, tol=1e-5 * (q2v.double() + xmax))
    say(f"qdots: max |Δ| {qd_err:.3g} over [{q_r}, {live_w * cap}, {n}]; dense refine "
        f"(qdots) vs fused refine_topk on the live-width adaptive plan: max |Δd²| "
        f"{dn_err:.3g}, {dn_differ} of 64 queries differ at near-ties "
        f"({dense_s * 1e3:.1f} ms vs {fused_s * 1e3:.1f} ms)")
    c_r = live_w * cap
    bms, bby = bound_ms(4 * (q_r * c_r * n + q_r * n + q_r * c_r), 2 * q_r * c_r * n)
    kernels.append({
        "name": "qdots", "route": "cuda", "source": "src/repro_torch/csrc/l2.cu",
        "replaces": "src/repro/kernels/l2.py:100", "path": "eval",
        "launches": eval_launches["qdots"], "max_abs_err": qd_err,
        # kernel and library in turns, 20 launches each: they differ by a
        # few percent, about the spread of one timing
        "ms": cuda_ms(lambda: ops.qdots(qq, rows_q), iters=20),
        "plain_ms": cuda_ms(lambda: qdots_plain(qq, rows_q)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: torch.bmm(rows_q, qq[:, :, None]), iters=20),
        "ms_again": cuda_ms(lambda: ops.qdots(qq, rows_q), iters=20),
        "library_ms_again": cuda_ms(lambda: torch.bmm(rows_q, qq[:, :, None]), iters=20),
        "library_call": "torch.bmm(rows, q[:, :, None])",
        "dense_refine_ms": dense_s * 1e3, "fused_refine_ms": fused_s * 1e3,
        "dense_vs_fused_max_abs_err": dn_err,
        "shape": f"q [{q_r},{n}], rows [{q_r},{c_r},{n}] -> [{q_r},{c_r}]",
        "ptxas": ptxas_of("qdots")})
    del rows_q

    # ---- fleet path, launch counts zeroed (the serve data and index go) ---
    del data, index, store, engines, eng, eng_p, x_c, z64, sp, lo_, hi_, spc, loc, hic
    del main_plan, d_dn, g_dn, d_fu, g_fu, qq
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9       # serve + eval + kernels
    fleet_launches, net_launches = fleet_path(args, dev, cfg, report)
    peak_gb = max(peak_gb, report["fleet"]["peak_memory_gb_with_checks"])
    torch.cuda.empty_cache()

    # ---- recall frontier, launch counts zeroed (the fleet is gone) -------
    frontier_launches = frontier_path(args, dev, cfg, report)
    peak_gb = max(peak_gb, report["frontier"]["peak_memory_gb"])
    # the paths' own shapes, checked against the plain versions after each
    # path's counts were read: their errors join the kernel rows
    for row in kernels:
        if row["name"] == "refine_topk":
            for path in ("fleet", "net", "frontier"):
                row[f"{path}_plans"] = report[path]["refine_checks"]
                row["max_abs_err"] = max([row["max_abs_err"]] + [
                    c["max_abs_err"] for c in row[f"{path}_plans"].values()])
        if row["name"] == "pairwise_l2":
            row["frontier_chunk"] = report["frontier"]["l2_check"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     row["frontier_chunk"]["max_abs_err"])
    say(f"peak device memory of the smoke: {peak_gb:.1f} GB")
    by_path = {"serve": launches, "eval": eval_launches, "fleet": fleet_launches,
               "net": net_launches, "frontier": frontier_launches}
    for row in kernels:
        row["launches_by_path"] = {p_: c[row["name"]] for p_, c in by_path.items()}

    line = json.dumps({"kernels": kernels})
    report["kernels"] = kernels
    report["max_memory_allocated_gb"] = peak_gb
    report["card"] = smi
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=2))
    say(line)
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
