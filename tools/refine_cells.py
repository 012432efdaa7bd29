#!/usr/bin/env python3
"""``refine_topk`` on the benchmark cells' own ticks, timed on one card.

Builds a cell's index as ``climbench`` does (its configuration's collection
and draws, ``cell.setup``), then plans sampled ticks of fresh queries for
each named cell (``--workloads``, the cells of ``BENCHMARK.json`` by
default) through the cell's engine, sorted by partition as
``ops.fused_refine_topk_device_plan`` sorts them.  For each tick it reports
the plan's sharing and the work the frozen count charges
(``climbench/work.tick_work``'s counts: ``kept_pairs``,
``unique_kept_records``, ``live_slots``), the distinct planned partitions,
the live (query, partition) segments and entries, and the refine's time
through the package's kernel: CUDA-event mean over ``--iters`` calls and
the profiler's device time by kernel.  The row bytes a query-major kernel
streams (``kept_pairs`` rows) and those a partition-major one needs
(``unique_kept_records`` rows) are given beside the time.

``--parent-csrc DIR`` also builds an older tree's kernel sources (as
``tools/kernel_variants.py`` does) and runs them on the same ticks, in
turns with the package's kernel: its time, and whether its answers equal
the package kernel's bit for bit.  ``--variants a,b`` adds edited builds of
the package's ``refine_topk.cu`` from ``kernel_variants.EDITS`` (probes
are timed only); each edited build is also run forced to the
partition-major design with one query an item, against the package
kernel forced alike.

Each tick also reports ``refine.item_tail`` as the package kernel's call
observes it (None where the call takes the query-major design).

The store may be dense or ragged (``partition_pad`` 0): the counts follow
the program's addressing (``kernels.refine_topk.entry_rows``), and a
``--parent-csrc`` build that takes dense stores only is left out on a
ragged one.

``--crossover 64,256,...`` times the two designs (the package's, each
forced) on the first tick's first Q queries of each cell for each Q, the
plan at its planned width and cut to its live width: the entries a
partition that decide which design a call takes (``Q · MP / P``, pads
included) against the sharing the plan has (live (query, partition) pairs
over distinct partitions), and which design is faster there; with
``--parent-csrc``, the older build's query-major design beside them.

Usage (needs a CUDA card and nvcc):
``python3 tools/refine_cells.py [--workloads a,b] [--ticks 2] [--seed 1]
[--parent-csrc DIR] [--variants tags_only] [--crossover 64,512,4096]
[--out chiprun_out/refine_cells.json]``
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

import torch  # noqa: E402

import kernel_variants as KV  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402


# kernel-name fragments the profiler's device time is summed by
KERNEL_NAMES = ("refine_partial_kernel", "refine_plan_kernel", "refine_part_kernel",
                "refine_count_kernel", "refine_scan_kernel", "refine_scatter_kernel",
                "refine_split_kernel", "refine_merge_kernel", "refine")


def plan_stats(store, sp, lo, hi, k: int, block: int = 16) -> dict:
    """Sharing and work of one partition-sorted ``[Q, MP]`` plan."""
    from climbench import work
    from repro_torch.kernels import refine_topk as RT
    rec_dfs, rec_gid, lay = RT._flat_tags(store.rec_dfs, store.rec_gid, store.ragged)
    live = sp >= 0
    seg_new = live.clone()
    seg_new[:, 1:] &= sp[:, 1:] != sp[:, :-1]
    segs_per_q = seg_new.sum(1)
    parts = torch.unique(sp[live])
    ent_per_seg = torch.bincount(torch.cumsum(seg_new.flatten().long(), 0)[live.flatten()])
    cap = store.capacity
    pairs, slots, uniq, kept_per_seg = 0, 0, [], []
    nlive = live.sum(1)
    for b0 in range(0, sp.shape[0], block):
        w = int(nlive[b0:b0 + block].max())
        if w == 0:
            continue
        bsp, blo, bhi = (t[b0:b0 + block, -w:] for t in (sp, lo, hi))
        row, _ = RT.entry_rows(lay, bsp)
        kept = RT.kept_slots(rec_dfs, rec_gid, bsp, blo, bhi, ragged=lay)
        pairs += int(kept.sum())
        slots += int(lay.extent[bsp[bsp >= 0].long()].sum())
        uniq.append(torch.unique(row[kept]))
        # kept records per (query, partition) segment
        bnew = bsp >= 0
        bnew[:, 1:] &= bsp[:, 1:] != bsp[:, :-1]
        seg_id = torch.cumsum(bnew.flatten().long(), 0).reshape(bsp.shape) - 1
        per_entry = kept.sum(-1).flatten()
        m = (bsp >= 0).flatten()
        kept_per_seg.append(torch.zeros(int(bnew.sum()), dtype=torch.long,
                                        device=sp.device).index_add_(
            0, seg_id.flatten()[m], per_entry[m]))
    unique = int(torch.unique(torch.cat(uniq)).numel()) if uniq else 0
    kps = torch.cat(kept_per_seg) if kept_per_seg else torch.zeros(1, dtype=torch.long)
    n = store.data.shape[-1]
    w = work.refine_topk_work(pairs, unique, slots, sp.shape[0], int(nlive.max()), n, k)
    return {"queries": sp.shape[0], "mp": sp.shape[1], "live_width": int(nlive.max()),
            "P": store.num_partitions, "cap": cap, "n": n, "k": k,
            "live_entries": int(live.sum()), "segments": int(seg_new.sum()),
            "distinct_partitions": int(parts.numel()),
            "queries_per_partition": int(seg_new.sum()) / max(1, int(parts.numel())),
            "segments_per_query_mean": float(segs_per_q.float().mean()),
            "segments_per_query_max": int(segs_per_q.max()),
            "entries_per_segment_max": int(ent_per_seg[1:].max()) if ent_per_seg.numel() > 1 else 0,
            "kept_pairs": pairs, "unique_kept_records": unique, "live_slots": slots,
            "segments_keeping_k_or_more": int((kps >= k).sum()),
            "kept_per_segment_mean": float(kps.float().mean()),
            "bound_ms": work.bound_s(w, torch.cuda.get_device_name(sp.device)) * 1e3,
            "bound_bytes": w.nbytes, "bound_flops": w.flops}


def crossover(eng, store, q_all, k: int, sizes, args, built=None) -> list:
    """Both designs on the first Q of ``q_all`` for each Q, the plan at its
    planned width and cut to its live width (rows per design: event ms,
    device ms; the two answers bit-equal), and each of ``built``'s builds
    that takes the store forced to its query-major design (event ms, and
    whether it equals the package's query-major answer bit for bit)."""
    from repro_torch.kernels import refine_topk as RT
    rows = []
    for qn in sizes:
        q = q_all[:qn].contiguous()
        sp, lo, hi = eng._plan(eng._featurize(q))[:3]
        o = torch.argsort(sp, dim=-1, stable=True)
        sp, lo, hi = (torch.gather(t, 1, o).to(torch.int32).contiguous() for t in (sp, lo, hi))
        w = max(1, int((sp >= 0).sum(1).max()))
        pairs, parts = RT.plan_sharing(sp)
        for width, (s_, l_, h_) in (("planned", (sp, lo, hi)),
                                    ("live", (sp[:, -w:].contiguous(), lo[:, -w:].contiguous(),
                                              hi[:, -w:].contiguous()))):
            a = (store.data, store.norms, store.rec_dfs, store.rec_gid, q, s_, l_, h_)
            rg = {"ragged": store.ragged}
            row = {"Q": qn, "width": width, "mp": s_.shape[1], "P": store.num_partitions,
                   "entries_per_partition": qn * s_.shape[1] / store.num_partitions,
                   "rule": ("partition" if qn * s_.shape[1] >= RT.PARTITION_MAJOR_MIN
                            * store.num_partitions else "query"),
                   "pairs": pairs, "partitions": parts,
                   "queries_per_partition": pairs / max(1, parts)}
            outs = {}
            for design, fn in (("query", RT._query_major), ("partition", RT._partition_major)):
                outs[design] = fn(*a, k, **rg)
                ms = []
                dev = []
                for _ in range(args.rounds):
                    m, d = KV.timed(lambda: fn(*a, k, **rg), KERNEL_NAMES, iters=args.iters)
                    ms.append(m)
                    dev.append(d.get("refine", 0.0))
                row[f"{design}_ms"] = min(ms)
                row[f"{design}_device_ms"] = min(dev)
            for bname, (lib, _) in (built or {}).items():
                if bname in KV.PROBES or (store.ragged is not None and not lib.ragged):
                    continue
                fn = (lambda lib=lib: KV.call_refine(lib, store, q, s_, l_, h_, k, "query"))
                got = fn()
                row[f"query_{bname}_equal"] = bool(torch.equal(got[0], outs["query"][0])
                                                   and torch.equal(got[1], outs["query"][1]))
                row[f"query_{bname}_ms"] = min(KV.timed(fn, KERNEL_NAMES, iters=args.iters)[0]
                                               for _ in range(args.rounds))
            row["equal"] = bool(torch.equal(outs["query"][0], outs["partition"][0])
                                and torch.equal(outs["query"][1], outs["partition"][1]))
            row["faster"] = ("partition" if row["partition_ms"] < row["query_ms"]
                             else "query")
            rows.append(row)
            print("crossover " + json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", default=None)
    ap.add_argument("--ticks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--variants", default="")
    ap.add_argument("--crossover", default="")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "refine_cells.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refine_cells: no CUDA card", file=sys.stderr)
        return 1
    from climbench import cell, spec
    from repro_torch.core.query import register_recall_target
    from repro_torch.kernels import ops
    from repro_torch.kernels import refine_topk as RT
    from repro_torch.kernels.refine_topk import ITEM_TAIL, SHARING, flush_sharing
    from repro_torch.obs.registry import REGISTRY
    from repro_torch.serve.knn_engine import ClimberEngine

    dev = torch.device("cuda", 0)
    bench = spec.load_benchmark(ROOT)
    names = (args.workloads.split(",") if args.workloads
             else [w["name"] for w in bench["workloads"]])
    builds = {}
    if args.parent_csrc:
        builds["parent"] = (Path(args.parent_csrc).resolve(), {})
    wanted = [v for v in args.variants.split(",") if v]
    if wanted:
        srcs, _ = KV.variant_sources("refine_topk", _lib.CSRC, set(wanted))
        builds.update({v: (_lib.CSRC, srcs[v]) for v in wanted if v in srcs})
    built = KV.build_all(builds, ROOT / "build" / "refine_cells",
                         only={"refine_topk.cu"}) if builds else {}
    _lib.library()
    report = {"card": KV.smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
              "parent_csrc": args.parent_csrc, "variants": sorted(built), "cells": {}}
    state = None
    for name in names:
        c = cell.load(name)
        if state is None:
            t = time.perf_counter()
            state = cell.setup(c, args.seed, dev, time.perf_counter())
            report["setup_s"] = time.perf_counter() - t
        elif c["config"]["name"] != report.get("config"):
            raise SystemExit("refine_cells: every cell must share one configuration")
        report["config"] = c["config"]["name"]
        mix = c["traffic"]
        if mix.get("planner"):
            register_recall_target(float(mix["planner"]["spend_factor"]),
                                   name=mix["planner"]["name"])
        index, data, order = state["index"], state["data"], state["order"]
        store = index.store
        eng = ClimberEngine(index, **mix["serving"])
        b, k = mix["set_size"], eng.k
        ticks = {}
        for tick in range(args.ticks):
            q = data[order[(3 + tick) * b:(4 + tick) * b]].contiguous()
            sp, lo, hi = eng._plan(eng._featurize(q))[:3]
            o = torch.argsort(sp, dim=-1, stable=True)
            sp, lo, hi = (torch.gather(t, 1, o).to(torch.int32).contiguous()
                          for t in (sp, lo, hi))
            row = {"plan": plan_stats(store, sp, lo, hi, k)}
            run_kernel = lambda: ops.fused_refine_topk(store.data, store.norms, store.rec_dfs,
                                                       store.rec_gid, q, sp, lo, hi, k,
                                                       ragged=store.ragged)
            h, tail = REGISTRY.histogram(SHARING), REGISTRY.histogram(ITEM_TAIL)
            flush_sharing()
            n0, s0, t0, u0 = h.count, h.sum, tail.count, tail.sum
            want = run_kernel()
            flush_sharing()
            row["queries_per_partition_counter"] = (h.sum - s0) / max(1, h.count - n0)
            row["item_tail"] = (tail.sum - u0) / (tail.count - t0) if tail.count > t0 else None
            runs = {"kernel": run_kernel}
            for bname, (lib, _) in built.items():
                if store.ragged is None or lib.ragged:
                    runs[bname] = (lambda lib=lib: KV.call_refine(lib, store, q, sp, lo, hi, k))
            row["equal_to_kernel"] = {}
            args_ = (store.data, store.norms, store.rec_dfs, store.rec_gid, q, sp, lo, hi)
            one = None
            for bname, fn in runs.items():
                if bname != "kernel" and bname not in KV.PROBES:
                    got = fn()
                    row["equal_to_kernel"][bname] = bool(torch.equal(got[0], want[0])
                                                         and torch.equal(got[1], want[1]))
                    print(f"{name} tick {tick}: {bname} equal to the kernel: "
                          f"{row['equal_to_kernel'][bname]}", flush=True)
                    if bname != "parent":
                        one = one or RT._partition_major(*args_, k, group=1,
                                                         ragged=store.ragged)
                        got = KV.call_refine(built[bname][0], store, q, sp, lo, hi, k,
                                             "partition", 1)
                        torch.cuda.synchronize()
                        row["equal_to_kernel"][f"{bname} group=1"] = bool(
                            torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
                            and torch.equal(one[0], want[0]) and torch.equal(one[1], want[1]))
                        print(f"{name} tick {tick}: {bname}, one query an item, equal to "
                              f"the kernel: {row['equal_to_kernel'][bname + ' group=1']}",
                              flush=True)
            times = {bname: {"ms": [], "device_ms": []} for bname in runs}
            for _ in range(args.rounds):
                for bname, fn in runs.items():
                    ms, d = KV.timed(fn, KERNEL_NAMES, iters=args.iters)
                    times[bname]["ms"].append(ms)
                    times[bname]["device_ms"].append(d)
            row["times"] = times
            if "pm_profile" in built:
                # cycles per phase over every block and call of one more round
                lib = built["pm_profile"][0]
                out = (ctypes.c_ulonglong * 8)()
                lib.climber_refine_profile(out)
                runs["pm_profile"]()
                torch.cuda.synchronize()
                lib.climber_refine_profile(out)
                names_ = ("setup", "tags", "ring_wait", "pool_cut", "score", "lists")
                total = sum(out[i] for i in range(6))
                row["profile_share"] = {nm: out[i] / total for i, nm in enumerate(names_)}
                print(f"{name} tick {tick}: phase shares {row['profile_share']}", flush=True)
            p = row["plan"]
            t_ms = min(times["kernel"]["ms"])
            row["rows_gb"] = {"kept_pairs": p["kept_pairs"] * (4 * p["n"] + 4) / 1e9,
                              "unique": p["unique_kept_records"] * (4 * p["n"] + 4) / 1e9,
                              "tags": p["live_slots"] * 8 / 1e9}
            row["kept_pair_rows_tb_per_s"] = row["rows_gb"]["kept_pairs"] / t_ms
            row["roofline_share"] = p["bound_ms"] / t_ms
            ticks[tick] = row
            print(json.dumps({"cell": name, "tick": tick, **row}), flush=True)
        report["cells"][name] = ticks
        if args.crossover:
            q = data[order[3 * b:4 * b]].contiguous()
            report.setdefault("crossover", {})[name] = crossover(
                eng, store, q, k, [int(x) for x in args.crossover.split(",")], args, built)
        del eng
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"card: {report['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
