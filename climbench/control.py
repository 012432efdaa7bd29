"""The check's control: the plain reference put in the program's place and
computed one precision lower (TF32 for the float32, TF32-off arithmetic the
configurations state), judged by the same check as a run.

    python3 climbench/control.py --workload <name> --seeds 11,12,13 --sets <n>

For each seed it makes the cell's collection, draws and queries as a run does,
takes the answers a run of ``--sets`` query sets would keep for the check,
and prints one JSON line: the control's numbers beside the cell's limits.
The control has to come out not correct.  It needs no measured window, so
the program does not run; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell: dict, seed: int, n_sets: int, dev) -> dict:
    import torch

    from climbench import cell as cellmod
    from climbench import check
    from climbench import data as cdata
    from climbench.reference import index as ref_index
    from climbench.reference import plan as ref_plan
    from climbench.reference import refine as ref_refine

    cfg, mix, checks = cell["config"], cell["traffic"], cell["checks"]
    ccfg = cfg["climber"]
    data, sample_idx, pivot_idx = cdata.deployment(cfg, dev)
    order = cdata.query_order(data.shape[0],
                              generator=cdata.generator(seed, "queries", dev))
    b = mix["set_size"]
    pos = cellmod.check_positions(seed, n_sets, b)
    rows = (np.arange(n_sets)[:, None] * b + pos).reshape(-1)
    rows = rows[cellmod.sample(rows.size, checks["sample"], seed)]
    queries = data[order[torch.as_tensor(rows, device=dev)]]
    variant, spend = cellmod.reference_planner(mix)
    k = mix["serving"].get("k") or ccfg["k"]

    t = time.perf_counter()
    low = ref_index.build(data, ccfg, sample_idx, pivot_idx, precision="tf32")
    sp, lo, hi = ref_plan.plan(low, ref_index.featurize(low, queries, "tf32"), variant, spend)
    dist, gid = ref_refine.answers(low.store, data, queries, sp, lo, hi, k, "tf32")
    del low
    ref = ref_index.build(data, ccfg, sample_idx, pivot_idx)
    sp, lo, hi = ref_plan.plan(ref, ref_index.featurize(ref, queries), variant, spend)
    pools = ref_refine.pools(ref.store, data, queries, sp, lo, hi)
    numbers = check.judge(dist.numpy(), gid.numpy(), queries, pools, data, k,
                          checks["tie_rel"])
    limits = checks["limits"]
    return {"seed": seed, "sampled": len(rows), "seconds": time.perf_counter() - t,
            "control": numbers, "limits": limits,
            "correct": check.verdict(numbers, limits)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from climbench import cell as cellmod
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cell = cellmod.load(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_numbers(cell, seed, args.sets, torch.device("cuda", 0))
        out["workload"] = args.workload
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
