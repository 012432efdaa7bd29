"""One run of one cell: set-up, the measured window, the check.

Set-up makes the configuration's collection on the device and draws the
build's sample and pivots, both from the configuration's ``data_seed`` (so
every run builds the same index), draws the run's query order from the
seed, builds the index through ``repro_torch``, wraps it in a
``ClimberEngine`` configured by the traffic file, and warms the engine up
on two query sets that the window does not use.  The window is a closed
loop with one analytics client: it reads its next query set of
``set_size`` distinct members of the collection (in the seed's order; no
query repeats in a run), hands it to ``ClimberEngine.run`` and waits for
the answers on the host, until ``seconds`` have passed; the last call ends
the window.  With ``trace`` the window runs under the profiler.  Just
before the window and just after it, outside the timed loop, the program's
registry is read (``registry.delta``), with the refine kernel's sharing
counts still in flight landed first.

After the window the program's state is freed and the plain reference
(``reference/``) rebuilds the index from the same collection and draws and
answers a sample of the window's queries; ``check.py`` compares.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from climbench import check, registry, spec, trace, work
from climbench import data as cdata
from climbench.reference import index as ref_index
from climbench.reference import plan as ref_plan
from climbench.reference import refine as ref_refine

CHECKS_PER_SET = 2          # answers kept for the check from each set


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _clock(dev) -> float:
    _sync(dev)
    return time.perf_counter()


def load(workload_name: str, root: Path = spec.ROOT) -> dict:
    bench = spec.load_benchmark(root)
    wl = spec.workload(bench, workload_name)
    return {"bench": bench, "workload": wl,
            "config": spec.config(bench, wl["config"], root),
            "traffic": spec.traffic(wl["traffic"], root),
            "checks": spec.checks(workload_name, root)}


def setup(cell: dict, seed: int, dev: torch.device, t_start: float) -> dict:
    """Everything before the window; ``t_start`` is the process's start on
    the host clock.  Returns the run's state and its set-up accounting."""
    acct: Dict[str, float] = {}
    t = time.perf_counter()
    import repro_torch  # noqa: F401  (sets TF32 off, as the program runs)
    from repro_torch.core.index import build_index
    from repro_torch.core.query import register_recall_target
    from repro_torch.serve.knn_engine import ClimberEngine
    from repro_torch.utils.config import ClimberConfig
    acct["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    acct["cuda_s"] = _clock(dev) - t
    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import _lib
        _lib.library()
    acct["library_s"] = time.perf_counter() - t

    cfg, mix = cell["config"], cell["traffic"]
    t = time.perf_counter()
    data, sample_idx, pivot_idx = cdata.deployment(cfg, dev)
    order = cdata.query_order(data.shape[0],
                              generator=cdata.generator(seed, "queries", dev))
    n_rows = data.shape[0]
    acct["data_s"] = _clock(dev) - t

    t = time.perf_counter()
    index = build_index(data, ClimberConfig(**cfg["climber"]), device=dev,
                        sample_idx=sample_idx, pivot_idx=pivot_idx)
    build_s = _clock(dev) - t
    for step, secs in index.build_seconds.items():
        if step != "total":
            acct[f"build_{step}_s"] = secs

    planner = mix.get("planner")
    if planner:
        register_recall_target(float(planner["spend_factor"]), name=planner["name"])
    engine = ClimberEngine(index, **mix["serving"])

    t = time.perf_counter()
    b = mix["set_size"]
    for w in range(mix.get("warmup_sets", 2)):
        engine.run(data[order[n_rows - (w + 1) * b:n_rows - w * b]].cpu().numpy())
    engine.reset_metrics()
    gc.collect()
    gc.freeze()
    acct["warmup_s"] = _clock(dev) - t
    return {"data": data, "order": order, "sample_idx": sample_idx,
            "pivot_idx": pivot_idx, "index": index, "engine": engine,
            "build_s": build_s, "build_seconds": dict(index.build_seconds),
            "setup_acct": acct, "setup_s": time.perf_counter() - t_start}


def check_positions(seed: int, n_sets: int, set_size: int) -> np.ndarray:
    """``[n_sets, CHECKS_PER_SET]``: the rows of each set whose answers the
    window keeps for the check, drawn from the seed."""
    pick = np.random.default_rng(cdata.sub_seed(seed, "check"))
    return np.stack([pick.choice(set_size, CHECKS_PER_SET, replace=False)
                     for _ in range(n_sets)])


def sample(kept_rows: int, size: int, seed: int) -> np.ndarray:
    """Which of the kept answers the check compares, drawn from the seed."""
    pick = np.random.default_rng(cdata.sub_seed(seed, "sample"))
    return np.sort(pick.choice(kept_rows, min(kept_rows, size), replace=False))


def window(state: dict, mix: dict, seed: int, seconds: float, dev,
           traced: bool) -> dict:
    """The closed loop; returns what the readers and the check need."""
    from repro_torch.kernels.refine_topk import flush_sharing
    from repro_torch.obs import REGISTRY
    engine, data, order = state["engine"], state["data"], state["order"]
    b = mix["set_size"]
    n_sets_max = (data.shape[0] - mix.get("warmup_sets", 2) * b) // b
    positions = check_positions(seed, n_sets_max, b)
    st0 = engine.stats.snapshot()
    # the warm-up's sharing counts land before the window, the window's after
    flush_sharing()
    reg0 = REGISTRY.snapshot()
    latencies, kept = [], []

    def loop():
        t0 = time.perf_counter()
        i = 0
        while True:
            if i == n_sets_max:
                raise RuntimeError("the collection ran out of fresh queries")
            q = data[order[i * b:(i + 1) * b]].cpu().numpy()
            t_hand = time.perf_counter()
            dist, gid, _ = engine.run(q)
            t_done = time.perf_counter()
            latencies.append(t_done - t_hand)
            for pos in positions[i]:
                kept.append((i * b + int(pos), dist[pos].copy(), gid[pos].copy()))
            i += 1
            if t_done - t0 >= seconds:
                return i, t_done - t0

    summary = None
    if traced:
        from repro_torch.obs import TRACER
        with trace.mirrored_spans(TRACER), trace.capture() as prof:
            n_sets, window_s = loop()
        summary = trace.reduce(prof)
        del prof
    else:
        n_sets, window_s = loop()
    st1 = engine.stats.snapshot()
    flush_sharing()
    reg = registry.delta(reg0, REGISTRY.snapshot())
    delta = {key: st1[key] - st0[key] for key in
             ("ticks", "queries", "featurize_s", "plan_s", "refine_s")}
    return {"n_sets": n_sets, "window_s": window_s, "latencies_s": latencies,
            "kept": kept, "stats": delta, "trace": summary, "registry": reg,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0}


def reference_planner(mix: dict):
    """The reference's planner for the traffic's ``variant``: a registered
    ``recall_target`` planner is the adaptive one at its spend factor."""
    planner = mix.get("planner")
    if planner and mix["serving"]["variant"] == planner["name"]:
        return "adaptive", float(planner["spend_factor"])
    return mix["serving"]["variant"], 1.0


def reference_check(state: dict, cell: dict, win: dict, seed: int, dev,
                    traced: bool) -> dict:
    """The reference's index, the check's numbers, and (traced) the refine
    work of sampled ticks."""
    cfg, mix, checks = cell["config"], cell["traffic"], cell["checks"]
    data, order = state["data"], state["order"]
    ccfg = cfg["climber"]
    t = time.perf_counter()
    ref = ref_index.build(data, ccfg, state["sample_idx"], state["pivot_idx"])
    variant, spend = reference_planner(mix)
    k = mix["serving"].get("k") or ccfg["k"]

    kept = win["kept"]
    take = sample(len(kept), checks["sample"], seed)
    rows = torch.as_tensor([kept[j][0] for j in take], device=dev)
    queries = data[order[rows]]
    dist = np.stack([kept[j][1] for j in take])
    gid = np.stack([kept[j][2] for j in take])
    sp, lo, hi = ref_plan.plan(ref, ref_index.featurize(ref, queries), variant, spend)
    pools = ref_refine.pools(ref.store, data, queries, sp, lo, hi)
    numbers = check.judge(dist, gid, queries, pools, data, k, checks["tie_rel"])
    out = {"numbers": numbers, "sampled": len(take), "reference_s": None,
           "refine_work": None}

    if traced:
        b = mix["set_size"]
        n_ticks = win["n_sets"]
        ticks = sorted(set(np.linspace(0, n_ticks - 1, min(n_ticks, 32))
                           .round().astype(int).tolist()))
        bounds = []
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
        for tick in ticks:
            q = data[order[tick * b:(tick + 1) * b]]
            tsp, tlo, thi = ref_plan.plan(ref, ref_index.featurize(ref, q), variant, spend)
            w = work.tick_work(ref.store.rec_dfs, ref.store.rec_gid,
                               tsp, tlo, thi, data.shape[1], k)
            bounds.append(work.bound_s(w, kind) if kind in work.PEAKS else None)
        out["refine_work"] = {"ticks": ticks, "bound_s": bounds}
    out["reference_s"] = _clock(dev) - t
    return out


def record(state: dict, win: dict, ref: dict) -> dict:
    """The run's record, which every metric reader reads."""
    return {"window_s": win["window_s"], "n_sets": win["n_sets"],
            "latencies_s": win["latencies_s"], "stats": win["stats"],
            "build_seconds": state["build_seconds"], "setup_s": state["setup_s"],
            "peak_bytes": win["peak_bytes"], "trace": win["trace"],
            "registry": win["registry"], "refine_work": ref["refine_work"]}


def end_to_end(rec: dict, set_size: int) -> Dict[str, float]:
    lat_ms = np.repeat(np.asarray(rec["latencies_s"]) * 1e3, set_size)
    return {"queries_per_s": rec["n_sets"] * set_size / rec["window_s"],
            "query_p95_ms": float(np.percentile(lat_ms, 95)),
            "peak_mem_gb": rec["peak_bytes"] / 1e9,
            "setup_s": rec["setup_s"]}


def run(workload_name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, dev: Optional[torch.device] = None,
        root: Path = spec.ROOT, adjust: Optional[Callable[[dict], None]] = None
        ) -> dict:
    """One run; returns the result's fields.  ``adjust`` edits the cell
    (its configuration, traffic and checks) before set-up: the CPU tests
    shrink it with it."""
    cell = load(workload_name, root)
    if adjust is not None:
        adjust(cell)
    dev = dev or torch.device("cuda", 0)
    mix = cell["traffic"]
    state = setup(cell, seed, dev, t_start)
    acct = state["setup_acct"]
    log("setup " + " ".join(f"{k}={v:.4f}" for k, v in acct.items())
        + f" build_s={state['build_s']:.4f} setup_s={state['setup_s']:.4f}")
    win = window(state, mix, seed, seconds, dev, traced)
    lat = np.asarray(win["latencies_s"]) * 1e3
    st = win["stats"]
    log(f"window sets={win['n_sets']} seconds={win['window_s']:.4f} "
        f"call_ms min={lat.min():.3f} median={np.median(lat):.3f} "
        f"max={lat.max():.3f} client_ms={(win['window_s'] * 1e3 - lat.sum()) / len(lat):.3f} "
        + " ".join(f"{k}_ms={st[k + '_s'] / st['ticks'] * 1e3:.3f}"
                   for k in ("featurize", "plan", "refine")))

    del state["engine"], state["index"]
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_check(state, cell, win, seed, dev, traced)
    rec = record(state, win, ref)
    limits = cell["checks"]["limits"]
    numbers = ref["numbers"]
    correct = check.verdict(numbers, limits)
    log(f"reference seconds={ref['reference_s']:.4f} sampled={ref['sampled']}"
        + (f" launch_share={win['trace']['launch_share']:.4f}" if traced else ""))

    bench, wl = cell["bench"], cell["workload"]
    if traced:
        metrics = spec.read_metrics(spec.per_layer(bench, wl["name"]), rec, root)
    else:
        e2e = end_to_end(rec, mix["set_size"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, wl["name"])}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(win["peak_bytes"])}
    result = {"correct": correct, "attempted": win["n_sets"] * mix["set_size"],
              "failed": 0, "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = win["trace"]["busy_s"]
        device["window_s"] = win["trace"]["window_s"]
        result["breakdown"] = trace.breakdown(win["trace"])
    result["setup"] = acct
    result["check"] = {name: {"value": numbers[name], "limit": limit}
                       for name, limit in limits.items()}
    for line in check.lines(numbers, limits):
        log(line)
    return result
