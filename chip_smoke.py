#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Drives the port's main path once on one NVIDIA card, at the paper's
configuration (``ClimberConfig()``: n=256, w=16, r=200, m=10, c=3000,
K=500): generates a z-normalised random-walk dataset on the card from
``--seed``, builds the CLIMBER index on the card, and serves queries drawn
from the dataset through ``ClimberEngine`` (adaptive at batch 64, k=500;
``knn`` and ``od_smallest`` one batch each).  Every kernel's launch count is
zeroed just before that run and read just after it.

Then, off the main path, it holds each CUDA kernel against its plain
PyTorch version on the same inputs at the main path's shapes, times both
with CUDA events (and, for PAA, the one PyTorch call that computes it),
traces one more adaptive tick with ``torch.profiler`` (device busy time and
idle share), checks the engine against per-query ``knn_query``, prints
recall@500 of the adaptive plan against an exact scan, and requires the
exhaustive plan to reproduce that scan.  Any failed phase raises and the
script exits non-zero.  Output, in order: phase lines, one
``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi`` name and power
limit, and the last line ``{"ok": true, "device": {...}}``.  ``--report
PATH`` also writes a longer JSON report there.

Usage: ``python3 chip_smoke.py [--seed 0] [--num 4194304] [--queries 256]
[--report PATH]``
from the repository root (it puts ``src/`` on ``sys.path`` itself).  It
needs a CUDA card and ``nvcc``; without a card it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num", type=int, default=4_194_304,
                    help="series in the dataset (the paper's scale, cut to one card)")
    ap.add_argument("--queries", type=int, default=256)
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
    from repro_torch.core.query import knn_query, plan as plan_queries
    from repro_torch.core.index import build_index
    from repro_torch.data import make_dataset, make_queries
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels.paa_kernel import paa_plain
    from repro_torch.kernels.pivot_rank import pivot_rank_plain
    from repro_torch.kernels.refine_topk import PAD_D2, masked_distances, refine_topk, topk_flat
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
    ptxas = [ln.strip() for ln in _lib.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"kernels: built/loaded libclimber_kernels.so in {build_s:.1f} s")
    for ln in ptxas:
        say(f"  ptxas {ln}")
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
    say(f"main-path launches: {launches}")
    report["serve"] = serve
    report["launches"] = launches
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the main path: {missing}")

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

    # recall@K of the first 64 queries against an exact scan (sanity figure)
    q64 = queries[:64]
    best_d = torch.full((64, cfg.k), float("inf"), device=dev)
    best_i = torch.full((64, cfg.k), -1, dtype=torch.int64, device=dev)
    q2 = (q64 * q64).sum(-1, keepdim=True)
    for lo in range(0, args.num, 1 << 20):
        x = data[lo:lo + (1 << 20)]
        d = q2 - 2.0 * (q64 @ x.T) + (x * x).sum(-1)[None, :]
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, torch.arange(lo, lo + x.shape[0], device=dev)
                           .expand(64, -1)], 1)
        best_d, pos = torch.topk(cat_d, cfg.k, dim=1, largest=False)
        best_i = torch.gather(cat_i, 1, pos)
    exact = best_i.cpu().numpy()
    recall = float(np.mean([len(set(gid[i]) & set(exact[i])) / cfg.k
                            for i in range(64)]))
    say(f"recall@{cfg.k} (adaptive, first 64 queries vs exact scan): {recall:.4f}")
    report["recall_at_k_adaptive"] = recall
    # the exhaustive plan through the same kernel must give the exact answer,
    # up to ties at the k-th distance
    d_ex, g_ex, _ = knn_query(index, q64, cfg.k, variant="exhaustive")
    d2_ex = (d_ex.double() ** 2).cpu().numpy()
    g_ex = g_ex.cpu().numpy()
    kth = best_d[:, -1].double().cpu().numpy()
    tol_ex = 1e-5 * (q2[:, 0].double().cpu().numpy() + float(store.norms.max()))
    hits = 0
    for i in range(64):
        extra = ~np.isin(g_ex[i], exact[i])
        hits += cfg.k - int(extra.sum())
        if (np.abs(d2_ex[i][extra] - kth[i]) > tol_ex[i]).any():
            raise SystemExit(f"exhaustive query {i} misses the exact answer")
    say(f"recall@{cfg.k} (exhaustive through refine_topk, same queries): "
        f"{hits / (64 * cfg.k):.4f} (misses only at k-th-distance ties)")
    report["recall_at_k_exhaustive"] = hits / (64 * cfg.k)

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
    s_k = ops.pivot_rank(z_k, piv, m)
    s_p = pivot_rank_plain(z_k, piv, m)
    bad = (s_k != s_p).any(dim=1).nonzero()[:, 0]
    gap = 0.0
    if bad.numel():
        zb = z_k[bad].double()
        d64 = ((zb[:, None, :] - piv.double()[None]) ** 2).sum(-1)   # exact
        dk = torch.gather(d64, 1, s_k[bad].long())
        dp = torch.gather(d64, 1, s_p[bad].long())
        gap = float((dk - dp).abs().max())
        tol = 1e-5 * float((zb * zb).sum(-1).max() + (piv * piv).sum(-1).max())
        if gap > tol:
            raise SystemExit(f"pivot_rank: {bad.numel()} rows differ with a "
                             f"distance gap {gap} > {tol}")
    say(f"pivot_rank: {bad.numel()} of {B} rows differ from the plain version, "
        f"all within a distance gap of {gap:.3g}")
    nbytes = B * w * 4 + r * w * 4 + B * m * 4
    flops = B * r * (2 * w + 3)
    bms, bby = bound_ms(nbytes, flops)
    kernels.append({
        "name": "pivot_rank", "route": "cuda",
        "source": "src/repro_torch/csrc/pivot_rank.cu",
        "replaces": "src/repro/kernels/pivot_rank.py:59",
        "launches": launches["pivot_rank"], "max_abs_err": gap,
        "ms": cuda_ms(lambda: ops.pivot_rank(z_k, piv, m)),
        "plain_ms": cuda_ms(lambda: pivot_rank_plain(z_k, piv, m), iters=2, warmup=1),
        "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "rows_differing": int(bad.numel()),
        "shape": f"[{B},{w}] x [{r},{w}] -> [{B},{m}]"})
    del s_p, z_k, s_k

    # refine_topk on one serving tick: 64 queries, adaptive plan (all slots)
    p4r, _ = index.featurize(q64)
    qp = plan_queries(index, p4r, variant="adaptive")
    order = torch.argsort(qp.sel_part, dim=-1, stable=True)
    sp, lo_, hi_ = (torch.gather(t_, 1, order).contiguous()
                    for t_ in (qp.sel_part, qp.sel_lo, qp.sel_hi))
    mp = sp.shape[1]
    d2_k, g_k = refine_topk(store.data, store.norms, store.rec_dfs,
                            store.rec_gid, q64, sp, lo_, hi_, k)
    # plain version on the plan compacted to its live width (pads sort first,
    # so the last columns hold every live entry in the same relative order)
    live_w = int((sp >= 0).sum(1).max())
    spc, loc, hic = sp[:, -live_w:], lo_[:, -live_w:], hi_[:, -live_w:]
    cap = store.capacity
    qc = max(1, int(2e9 // (live_w * cap * n * 4)))

    def plain_refine(collect=None):
        outs = []
        for a in range(0, 64, qc):
            sl = slice(a, a + qc)
            d2, g = masked_distances(store.data, store.norms, store.rec_dfs,
                                     store.rec_gid, q64[sl], spc[sl], loc[sl], hic[sl])
            if collect is not None:
                collect(sl, d2)
            outs.append(topk_flat(d2, g, k))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    touched = torch.zeros(store.num_partitions, cap, dtype=torch.bool, device=dev)
    kept_pairs = [0]

    def collect(sl, d2):
        kept = (d2 < PAD_D2).view(d2.shape[0], live_w, cap)
        kept_pairs[0] += int(kept.sum())
        pid = spc[sl].clamp(min=0).long()
        slots = torch.zeros_like(touched, dtype=torch.int32)
        slots.index_put_((pid[:, :, None].expand(-1, -1, cap),
                          torch.arange(cap, device=dev).expand_as(kept)),
                         kept.to(torch.int32), accumulate=True)
        touched.logical_or_(slots > 0)

    d2_p, g_p = plain_refine(collect)
    q2v = (q64 * q64).sum(-1, keepdim=True)
    xmax = float(store.norms.max())
    tol = 1e-5 * (q2v + xmax)
    derr = (d2_k - d2_p).abs()
    if bool((derr > tol).any()):
        raise SystemExit(f"refine_topk: |Δd²| {float(derr.max())} exceeds "
                         f"1e-5·(‖q‖²+‖x‖²)")
    gid_diff = g_k != g_p
    kth = d2_p[:, -1:]
    # a differing gid must sit at a near-tie: its distance within tol of the
    # plain answer at that rank, and a set difference only at the k-th boundary
    for i in gid_diff.any(1).nonzero()[:, 0].tolist():
        a, b = set(g_k[i].tolist()), set(g_p[i].tolist())
        extra = a - b
        if extra:
            dk_extra = d2_k[i][torch.isin(g_k[i], torch.tensor(sorted(extra), device=dev))]
            if bool(((dk_extra - kth[i]).abs() > tol[i]).any()):
                raise SystemExit(f"refine_topk: query {i} answer set differs "
                                 f"away from the k-th distance")
    say(f"refine_topk: max |Δd²| {float(derr.max()):.3g}; "
        f"{int(gid_diff.any(1).sum())} of 64 queries differ in gid order at near-ties; "
        f"plan width {mp}, live width {live_w}, cap {cap}")
    uniq_kept = int(touched.sum())
    live_slots = int((sp >= 0).sum()) * cap
    nbytes = (uniq_kept * (4 * n + 4) + live_slots * 8 + 64 * n * 4
              + 3 * 64 * mp * 4 + 64 * k * 8)
    flops = kept_pairs[0] * (2 * n + 3)
    bms, bby = bound_ms(nbytes, flops)
    kernels.append({
        "name": "refine_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/refine_topk.cu",
        "replaces": "src/repro/kernels/refine_topk.py:189",
        "launches": launches["refine_topk"], "max_abs_err": float(derr.max()),
        "ms": cuda_ms(lambda: refine_topk(store.data, store.norms, store.rec_dfs,
                                          store.rec_gid, q64, sp, lo_, hi_, k)),
        "plain_ms": cuda_ms(plain_refine, iters=2, warmup=1),
        "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "kept_pairs": kept_pairs[0], "unique_kept_records": uniq_kept,
        "shape": f"Q=64 MP={mp} (live {live_w}) cap={cap} n={n} k={k}"})

    line = json.dumps({"kernels": kernels})
    report["kernels"] = kernels
    report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
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
