"""Run one cell of the benchmark once, on the card it is started on.

    python3 climbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up, then ``--seconds`` of measured window, then the check against the
plain reference; the last line of standard output is the result (JSON), and
the last lines of standard error are the numbers compared, each beside its
limit.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.  Without enough CUDA
devices, without the program beside the benchmark, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def fail(msg: str, code: int = 2) -> None:
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the program (src/repro_torch) is not beside the benchmark in {ROOT}")
    # every cache the program or PyTorch keeps lives at a fixed path inside
    # the checkout
    cache = ROOT / "build" / "climbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from climbench import cell, spec

    # one client thread drives the engine; no CPU worker threads beside it
    torch.set_num_threads(1)

    wl = spec.workload(spec.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < wl["chips"]:
        fail(f"{args.workload} needs {wl['chips']} CUDA devices, "
             f"{torch.cuda.device_count()} found")

    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        fail(f"modules loaded that the benchmark must not load: {loaded}", 3)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
