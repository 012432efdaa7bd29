#!/usr/bin/env python3
"""Design variants of the ``pivot_rank`` CUDA kernel, timed on one card.

Builds ``src/repro_torch/csrc/pivot_rank.cu`` as it is and in variants made
by editing its text (one ``nvcc`` each, all started together), then runs
each on the smoke's inputs: the PAA rows of a 2^22-series random-walk
dataset (w = 16) against 200 pivots drawn from them, m = 10, and 64 of
those rows (one serving tick's featurize).  Variants:

* ``package``: the kernel as committed (lanes per row picked from B; two
  rows per lane with a lane per row);
* ``lanes1`` / ``lanes32``: the same build with one lane, or a warp, per
  row forced through the C entry;
* ``rows1``, ``rows1_blocks4``, ``rows2_blocks1``, ``rows4``: rows per lane
  and ``__launch_bounds__`` blocks per SM of the w = 16, m = 10 list
  (``rows1`` is the design before several rows per lane);
* ``packed``: a row per lane, each list entry a single 32-bit key, the
  distance's bits with the low 8 mantissa bits replaced by the pivot id
  (r <= 256), inserted with integer min/max.  It orders by a 15-bit
  mantissa, so its near ties are coarser than the committed kernel's;
* ``no_merge``: a timing probe, not a kernel: the distance pass alone.

Each variant's output is held against the plain version with the smoke's
near-tie rule (rows may differ only at a distance gap of at most
1e-5·(max ‖x‖² + max ‖p‖²)) and against the committed kernel bit for bit.
Times are CUDA-event means over 20 calls at 2^22 rows, and profiler
device time at 64 rows, taken in three interleaved rounds.

Usage (needs a CUDA card and nvcc):
``python3 tools/pivot_rank_variants.py [--seed 0] [--num 4194304]
[--out chiprun_out/pivot_rank_variants.json]``
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _lib  # noqa: E402

W, R, M = 16, 200, 10
PROBES = ("no_merge",)        # variants timed only: their output is not P4->
KROWS = re.compile(r"constexpr int kRows = (\d);")
BLOCKS = re.compile(r"\(rows == 1 \? (\d) : (\d)\)")

# The row loop's body with packed 32-bit (distance, id) keys, a row per lane.
PACKED_ROW = r"""
    static_assert(R == 1, "the packed variant keeps a row per lane");
    const long long row = row0 + threadIdx.x / g;
    const bool live = row < b;
    float x[W];
    float x2 = 0.f;
#pragma unroll
    for (int t = 0; t < W; ++t) {
      x[t] = live ? __ldg(paa + row * W + t) : 0.f;
      x2 = fmaf(x[t], x[t], x2);
    }
    unsigned bk[M];
#pragma unroll
    for (int t = 0; t < M; ++t) bk[t] = 0xffffffffu;
    unsigned* sk = reinterpret_cast<unsigned*>(sd);
    for (int c = 0; c < chunks; ++c) {
      const int j0 = c * step + sub;
      const float4* pc = sp + j0 * PITCH;
      unsigned worst = bk[M - 1];
#pragma unroll
      for (int t = 0; t < M; ++t) worst = (!EXACT && t == m - 1) ? bk[t] : worst;
      worst = live ? worst : 0u;
      unsigned cand = 0;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4* p = pc + i * g * PITCH;
        float ab = 0.f;
#pragma unroll
        for (int t = 0; t < W4; ++t) {
          const float4 v = p[t];
          ab = fmaf(x[4 * t], v.x, ab);
          ab = fmaf(x[4 * t + 1], v.y, ab);
          ab = fmaf(x[4 * t + 2], v.z, ab);
          ab = fmaf(x[4 * t + 3], v.w, ab);
        }
        const float d = fmaxf(__fadd_rn(__fadd_rn(x2, ab), p[W4].x), 0.f);
        const unsigned key = (__float_as_uint(d) & 0xffffff00u) |
                             static_cast<unsigned>((j0 + i * g) & 0xff);
        sk[i * kThreads] = key;
        cand |= static_cast<unsigned>(key < worst) << i;
      }
      while (__any_sync(kFull, cand)) {
        const int first = __ffs(cand) - 1;
        cand &= cand - 1;
        const unsigned ck =
            first >= 0 ? sk[(first & (kChunk - 1)) * kThreads] : 0xffffffffu;
#pragma unroll
        for (int t = M - 1; t > 0; --t) bk[t] = min(bk[t], max(ck, bk[t - 1]));
        bk[0] = min(bk[0], ck);
      }
    }
    if (g == 1) {
#pragma unroll
      for (int t = 0; t < M; ++t)
        if (live && t < m) out[row * m + t] = static_cast<int>(bk[t] & 0xffu);
      continue;
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (k >= m) break;
      unsigned mk = bk[0];
      for (int off = 1; off < g; off <<= 1)
        mk = min(mk, __shfl_xor_sync(kFull, mk, off));
      const bool pop = bk[0] == mk;
#pragma unroll
      for (int t = 0; t < M - 1; ++t) bk[t] = pop ? bk[t + 1] : bk[t];
      bk[M - 1] = pop ? 0xffffffffu : bk[M - 1];
      if (live && sub == 0) out[row * m + k] = static_cast<int>(mk & 0xffu);
    }
  }
}
"""


def packed(src: str) -> str:
    """The source with a row per lane and PACKED_ROW as the row loop's body."""
    start, end = "    float x[R][W];\n", "\n// Lanes per row when the caller"
    assert src.count(start) == 1 and src.count(end) == 1, \
        "row loop changed; update this script"
    head, rest = src.split(start)
    return edit(head, 1, 3, 1) + PACKED_ROW + end + rest.split(end)[1]


def edit(src: str, rows: int, blocks1: int, blocks_n: int) -> str:
    """The source with ``rows`` rows per lane and ``blocks1`` / ``blocks_n``
    blocks per SM for one row / several rows per lane."""
    assert len(KROWS.findall(src)) == 1 and len(BLOCKS.findall(src)) == 1, \
        "kRows or min_blocks changed; update this script"
    src = KROWS.sub(f"constexpr int kRows = {rows};", src)
    return BLOCKS.sub(f"(rows == 1 ? {blocks1} : {blocks_n})", src)


def variants(src: str):
    merge = "      while (__any_sync(kFull, more)) {"
    assert src.count(merge) == 1, "merge loop changed; update this script"
    return {"package": src,
            "rows1": edit(src, 1, 3, 1), "rows1_blocks4": edit(src, 1, 4, 1),
            "rows2_blocks1": edit(src, 2, 3, 1), "rows4": edit(src, 4, 3, 1),
            "packed": packed(src),
            # a timing probe, not a kernel: the distance pass without merges
            "no_merge": src.replace(merge, "      while (false) {")}


def build_all(sources: dict, root: Path) -> dict:
    """One nvcc per variant, all started together; returns name -> (lib, log)."""
    nvcc = _lib.find_nvcc()
    procs = {}
    for name, text in sources.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        shutil.copy(_lib.CSRC / "climber_kernels.cuh", d)
        (d / "pivot_rank.cu").write_text(text)
        cmd = [nvcc, *_lib.NVCC_FLAGS, "-shared", "-I", str(d),
               str(d / "pivot_rank.cu"), "-o", str(d / "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        fn = lib.climber_pivot_rank
        fn.restype, fn.argtypes = _lib._SIGNATURES["climber_pivot_rank"]
        built[name] = (fn, log)
    return built


def ptxas_of(log: str, entry: str) -> dict:
    """Registers and spills of the entry whose mangled name holds ``entry``."""
    info, on = {}, False
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            on = entry in ln
        elif on and "bytes spill stores" in ln:
            f = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
            info.update(spill_stores=f[1], spill_loads=f[2])
        elif on and "Used" in ln and "registers" in ln:
            info["registers"] = int(ln.split("Used")[1].split()[0])
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num", type=int, default=1 << 22)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "pivot_rank_variants.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pivot_rank_variants: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pivots import select_pivots
    from repro_torch.data import make_dataset
    from repro_torch.kernels.paa_kernel import paa_plain
    from repro_torch.kernels.pivot_rank import pivot_distances_plain, pivot_rank_plain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    src = (_lib.CSRC / "pivot_rank.cu").read_text()
    built = build_all(variants(src), ROOT / "build" / "pivot_rank_variants")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = make_dataset("randomwalk", args.num, 256, generator=gen)
    z = paa_plain(data, W).contiguous()
    del data
    piv = select_pivots(z, R, generator=gen).contiguous()
    z64 = z[torch.randperm(z.shape[0], generator=gen, device=dev)[:64]].contiguous()
    stream = _lib.stream(dev)

    def run(fn, x, g):
        out = torch.empty((x.shape[0], M), dtype=torch.int32, device=dev)
        _lib.check(fn(x.data_ptr(), piv.data_ptr(), out.data_ptr(), x.shape[0],
                      W, R, M, g, stream), "pivot_rank variant")
        return out

    calls = {"package": ("package", 0), "lanes1": ("package", 1),
             "lanes32": ("package", 32), **{v: (v, 0) for v in built if v != "package"}}

    def near_ties(got, x):
        want = pivot_rank_plain(x, piv, M)
        bad = (got != want).any(dim=1).nonzero()[:, 0]
        gap = 0.0
        if bad.numel():
            xb = x[bad].double()
            d64 = ((xb[:, None, :] - piv.double()[None]) ** 2).sum(-1)
            gap = float((torch.gather(d64, 1, got[bad].long())
                         - torch.gather(d64, 1, want[bad].long())).abs().max())
        tol = 1e-5 * float((x * x).sum(-1).max() + (piv * piv).sum(-1).max())
        return int(bad.numel()), gap, tol

    res = {name: {"ptxas": {f"rows{k}": ptxas_of(built[b][1], f"pivot_rank_kernelILi16ELi10ELb1ELi{k}E")
                            for k in (1, 2, 4)}}
           for name, (b, _) in calls.items()}
    for shape, x in (("2^22", z), ("64", z64)):
        ref = run(built["package"][0], x, 0)
        for name, (b, g) in calls.items():
            if name in PROBES:
                continue
            got = run(built[b][0], x, g)
            rows, gap, tol = near_ties(got, x)
            res[name][shape] = {"equal_to_package": bool(torch.equal(got, ref)),
                                "rows_differing_from_plain": rows, "gap": gap,
                                "tol": tol, "within_rule": gap <= tol}
        del ref
    for name in calls:
        res[name]["ms_2^22"], res[name]["device_ms_64"] = [], []
    for _ in range(3):                       # interleaved rounds
        for name, (b, g) in calls.items():
            fn = built[b][0]
            for _ in range(2):
                run(fn, z, g)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                run(fn, z, g)
            e1.record()
            torch.cuda.synchronize()
            res[name]["ms_2^22"].append(e0.elapsed_time(e1) / 20)
            run(fn, z64, g)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
                for _ in range(50):
                    run(fn, z64, g)
                torch.cuda.synchronize()
            us = sum(e.time_range.elapsed_us() for e in pr.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "pivot_rank" in e.name)
            res[name]["device_ms_64"].append(us / 1e3 / 50)
    lib_ms = []
    for _ in range(2):
        torch.topk(pivot_distances_plain(z, piv), M, dim=-1, largest=False)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.topk(pivot_distances_plain(z, piv), M, dim=-1, largest=False)
        e1.record()
        torch.cuda.synchronize()
        lib_ms.append(e0.elapsed_time(e1))
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "shape": f"[{z.shape[0]},{W}] x [{R},{W}] -> m={M}",
              "library_ms_2^22": lib_ms, "variants": res}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    for name, v in res.items():
        check = "timing probe, output not checked" if name in PROBES else (
            f"equal {v['2^22']['equal_to_package']}/{v['64']['equal_to_package']} "
            f"rows_diff {v['2^22']['rows_differing_from_plain']} gap {v['2^22']['gap']:.3g} "
            f"(tol {v['2^22']['tol']:.3g})")
        print(f"{name:13s} 2^22 ms {['%.4f' % t for t in v['ms_2^22']]} "
              f"64-row device ms {['%.5f' % t for t in v['device_ms_64']]} "
              f"{check} ptxas {v['ptxas']}")
    print(f"library 2^22 ms {lib_ms}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
