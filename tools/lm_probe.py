#!/usr/bin/env python3
"""Two measurements behind the ``lm`` path of ``chip_smoke.py``, on one card.

1. **Where a decode tick goes.** internlm2-1.8b at its full config (bf16,
   seeded), a prefill of 8 rows of 100 tokens into a 512-position cache,
   then ``decode_step`` timed over 10 ticks (host clock, synchronised) and
   traced once with ``torch.profiler``: device kernels launched per tick,
   their device time, and the kernel names that take the most of it.
2. **How the kNN-LM datastore routes.** The smoke's datastore (``--steps``
   × 16 × 1,023 hidden-state proxies, ``logits[..., :2048]``), and for its
   first 2^16 … 2^19 rows and all of it, the CLIMBER build's partition
   sizes with the example's configuration (n = 2048, w = 16, r = 48,
   m = 6, c = 256, α = 0.25): P, the mean and fullest partition, the
   quantiles, and the dense ``[P, cap, n]`` store those sizes need.  The
   build runs steps 1–4 and stops before the store is allocated.

Usage (needs a CUDA card): ``python3 tools/lm_probe.py [--seed 0]
[--steps 64] [--out PATH]``; prints both as JSON lines, and writes them
to PATH when given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Stop(Exception):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import index as core_index
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model, decode_step, prefill
    from repro_torch.utils.config import ClimberConfig

    dev = torch.device("cuda", 0)
    out = {"card": torch.cuda.get_device_name(0), "args": vars(args)}
    cfg = get_config("internlm2-1.8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)

    # ---- 1. one decode tick ------------------------------------------------
    with torch.no_grad():
        _, cache = prefill(model, params, {"tokens": torch.zeros(
            (8, 100), dtype=torch.int32, device=dev)}, max_len=512)
        tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
        for _ in range(3):
            decode_step(model, params, cache, tok)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            decode_step(model, params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 100
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
            decode_step(model, params, cache, tok)
            torch.cuda.synchronize()
    kernels = [e for e in pr.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    out["decode_tick"] = {"slots": 8, "max_len": 512, "wall_ms": wall_ms,
                          "kernels": len(kernels),
                          "device_ms": sum(by_name.values()),
                          "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    print("decode tick: " + json.dumps(out["decode_tick"]), flush=True)

    # ---- 2. the datastore's partition sizes ----------------------------------
    d, per = cfg.d_model, 16 * 1023
    pipe = TokenPipeline(cfg, global_batch=16, seq_len=1024, seed=args.seed, device=dev)
    ds = torch.empty((args.steps * per, d), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for step in range(args.steps):
            tokens = pipe.batch_at(step)["tokens"][:, :-1]
            ds[step * per:(step + 1) * per] = model(params, {"tokens": tokens})[
                ..., :d][:, :-1].reshape(-1, d)
    del params, cache
    torch.cuda.empty_cache()
    seen = {}

    def sizes_only(data, part, rec_dfs, num_partitions, pad=None):
        c = torch.bincount(part.long(), minlength=num_partitions).float()
        q = torch.quantile(c, torch.tensor([0.5, 0.9, 0.99], device=c.device))
        seen.update(P=num_partitions, mean=float(c.mean()), fullest=int(c.max()),
                    p50_p90_p99=[float(v) for v in q],
                    dense_store_gb=num_partitions * int(c.max()) * d * 4 / 1e9)
        raise _Stop

    core_index.build_store = sizes_only
    ccfg = ClimberConfig(series_len=d, paa_segments=16, num_pivots=48, prefix_len=6,
                         capacity=256, sample_frac=0.25, max_centroids=24, k=16,
                         candidate_groups=4, adaptive_factor=4)
    out["datastore"] = {}
    for n in sorted({1 << 16, 1 << 17, 1 << 18, 1 << 19, ds.shape[0]}):
        if n > ds.shape[0]:
            continue
        seen.clear()
        try:
            core_index.build_index(ds[:n], ccfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(args.seed))
        except _Stop:
            pass
        out["datastore"][n] = dict(seen)
        print(f"datastore rows {n}: " + json.dumps(seen), flush=True)
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
