#!/usr/bin/env python3
"""Design variants and timing probes of the ``refine_topk``,
``pairwise_l2`` and ``paa`` CUDA kernels, timed on one card.

Builds the kernel library from a source directory (``--csrc``, the
package's ``src/repro_torch/csrc`` by default) as it is, and in variants
made by editing the text of ``refine_topk.cu``, ``l2.cu`` or ``paa.cu``
(one ``nvcc`` per variant, all started together; with ``--kernel paa``
only ``paa.cu`` is compiled).  ``--parent-csrc DIR`` also builds an
older tree's sources unedited (``parent``), so that two designs are timed
in turns in one call.  An edit whose anchor text is not in the source is
skipped and reported, so the one list serves several designs.

Inputs are the smoke's (``chip_smoke.py``): a 2^22-series random walk
(``--seed``), its CLIMBER index at ``ClimberConfig()``, 256 queries drawn
from it.  ``refine_topk`` runs on three partition-sorted plans: adaptive on
queries 0-63 (the smoke's timed batch), adaptive on queries 64-127 (the
smoke's traced tick) and ``od_smallest`` on queries 0-63; and on seeded
stand-ins of the kNN-LM plan's shape (n = 2,048, K = 16) and the dry-run
slot's (50 queries x 16 whole partitions of 3,000 x 256); each plan's
``kept_pairs`` / ``unique_kept_records`` and byte bound come with it.
``pairwise_l2`` runs on 64 queries x the first 2^20 series (one Dss chunk).
``paa`` (w = 16) runs on the 2^22 series (the paper's shape), on 2^18
seeded normal rows of n = 2,048 (the kNN-LM's step-4 chunk) and on 64 of
the series (one serving tick); every build that computes the function,
the parent's included, must equal the committed kernel bit for bit, and
the committed kernel must equal ``paa_sequential`` on up to 8,192 sampled
rows (the tool exits 1 otherwise).  The library call
``x.view(B, w, n // w).mean(-1)`` is timed beside them as ``library``.

Each variant that computes the function is held against the plain version
(the smoke's rules: ``|Δd²| <= 1e-5·(‖q‖²+‖x‖²)``, refine answers that
differ only at k-th-distance near-ties) and against the unedited build bit
for bit.  A probe (a name in ``PROBES``) leaves work out, so its output is
not checked: it is timed only.  Times are CUDA-event means over 20 calls,
and the profiler's device time per kernel name, in three interleaved
rounds.

Every refine build is also forced to the partition-major design on every
plan, with one query an item and with the most, and held bit for bit
against the package kernel forced alike: with ``pm_checked`` (the kernel
with its memory indices checked, trapping on a bad one) this checks the
committed kernel's bounds at every shape.  ``--variants a,b`` builds only
the named edits; without it every edit but ``FAULTS`` (variants that fault
by design) is built.

Usage (needs a CUDA card and nvcc):
``python3 tools/kernel_variants.py [--kernel refine_topk|pairwise_l2|paa|all]
[--csrc DIR] [--parent-csrc DIR] [--variants a,b] [--rounds 3]
[--out chiprun_out/kernel_variants.json]``
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _lib  # noqa: E402

# The tma_bulk variant's kernel, put in place of paa.cu's (which is renamed
# and left unused).  Its mbarriers sit after the ring in dynamic shared
# memory.
PAA_TMA = """__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\\n .reg .pred p;\\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                 " selp.u32 %0, 1, 0, p;\\n}\\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
paa_kernel(const typename Chunk<V>::T* __restrict__ x, float* __restrict__ out,
           long long segs, int seg, int P, long long tiles) {
  using T = typename Chunk<V>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int cps = seg / (V / 4);
  const int slot = P * cps;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(ring + kStages * slot);
  const long long step = gridDim.x;
  long long tile = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(smem_u32(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long t, int s) {
    const int np = tile_segments(t, P, segs);
    if (np > 0)
      bulk_load(ring + s * slot, x + t * P * cps, static_cast<unsigned>(np) * cps * V,
                full + s);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages - 1; ++s) issue(tile + s * step, s);
  for (int i = 0; tile < tiles; ++i, tile += step) {
    bar_wait(full + i % kStages, (i / kStages) & 1);
    __syncthreads();
    if (threadIdx.x == 0) issue(tile + (kStages - 1) * step, (i + kStages - 1) % kStages);
    const T* buf = ring + (i % kStages) * slot;
    const int np = tile_segments(tile, P, segs);
    for (int p = threadIdx.x; p < np; p += kThreads) {
      const T* s = buf + p * cps;
      float acc = 0.f;
      for (int j = 0; j < cps; ++j) acc = add_chunk(acc, s[j]);
      out[tile * P + p] = acc / static_cast<float>(seg);
    }
  }
}

"""

XM_SWIZZLED = ("  const int xm = V == 16 && (cps & (cps - 1)) == 0 ? "
               "(cps >= 8 ? 7 : cps - 1) : 0;")

# units of 8 rows x 4 queries in place of 4 x 8 (a variant's edits)
UNIT_8X4 = [("constexpr int kGw = 8;", "constexpr int kGw = 4;"),
            ("constexpr int kRw = 4;", "constexpr int kRw = 8;")]

# name -> (source file, [(anchor, replacement), ...]).  Anchors of the PR 12
# design and of the redesign may both be listed: what is absent is skipped.
EDITS = {
    "refine_topk": {
        # the PR 12 design's phases, one left out at a time
        "tags_only": ("refine_topk.cu", [
            ("const int nev = s_nev;", "const int nev = 0 * s_nev;")]),
        "rows_no_insert": ("refine_topk.cu", [
            ("if (key < s_thresh) keys[k + atomicAdd(&s_nbuf, 1)] = key;",
             "if (key == 0x5a5a5a5a5a5aull) keys[k] = key;")]),
        "no_final_sort": ("refine_topk.cu", [
            ("    for (int i = k + s_nbuf + tid; i < L; i += kThreads) keys[i] = kEmpty;\n"
             "    bitonic_sort(keys, L);\n  }\n  u64* out",
             "  }\n  u64* out")]),
        "merge_only": ("refine_topk.cu", [
            ("    int vec4) {\n  const int q = blockIdx.y;",
             "    int vec4) {\n  if (mp > 0) return;\n  const int q = blockIdx.y;")]),
        # the redesign: the block set-up alone, and design choices
        "setup_only": ("refine_topk.cu", [
            ("  const int end = mp * cap;", "  const int end = first_live * cap;")]),
        "rows4": ("refine_topk.cu", [
            ("constexpr int R = NV == 0 ? 4 : 8;", "constexpr int R = NV == 0 ? 4 : 4;")]),
        "waves1": ("refine_topk.cu", [
            ("constexpr int kWaves = 4;", "constexpr int kWaves = 1;")]),
        "waves2": ("refine_topk.cu", [
            ("constexpr int kWaves = 4;", "constexpr int kWaves = 2;")]),
        "waves8": ("refine_topk.cu", [
            ("constexpr int kWaves = 4;", "constexpr int kWaves = 8;")]),
        # 1,024-slot chunks: four tag pairs in flight per thread
        "scan4": ("refine_topk.cu", [
            ("constexpr int kScanPer = 8;", "constexpr int kScanPer = 4;")]),
        "ldg": ("refine_topk.cu", [
            ("? __ldcs(reinterpret_cast<const float4*>(data + slot[r] * n) + j)",
             "? __ldg(reinterpret_cast<const float4*>(data + slot[r] * n) + j)")]),
        # a probe: every live slot with a record kept (no DFS range, no
        # dedupe), so the row pass streams whole partitions
        "keep_all": ("refine_topk.cu", [
            ("      bool keep = gid[u] >= 0;\n      if (keep) {",
             "      bool keep = gid[u] >= 0;\n      if (false) {")]),
        # the partition-major design's phases: tags and lists only (no row
        # is read), and rows streamed but never scored
        "pm_tags_only": ("refine_topk.cu", [
            ("      const int nt = (nev + tile - 1) / tile;",
             "      const int nt = 0 * nev;")]),
        "pm_no_score": ("refine_topk.cu", [
            ("          if (!__reduce_or_sync(0xffffffffu, um)) continue;",
             "          if (um | 1u) continue;")]),
        "pm_no_sort": ("refine_topk.cu", [
            ("const u64 kth = select_warp(a, cnt, k, hist, lane);\n"
             "              keep_warp(a, cnt, kth, lane);",
             "const u64 kth = kEmpty;"),
            ("                s_cnt[g] = k;", "                s_cnt[g] = 0;"),
            ("      int m = s_cnt[g];", "      int m = 0 * s_cnt[g];")]),
        # clock64 per phase of the scoring block, summed over blocks into
        # g_prof (read by climber_refine_profile): item set-up, tags, ring
        # waits, pool cuts, scoring, the item's lists
        "pm_profile": ("refine_topk.cu", [
            ('#include "climber_kernels.cuh"\n',
             '#include "climber_kernels.cuh"\n__device__ unsigned long long g_prof[8];\n'
             '#define MARK(i) if (tid == 0) { const unsigned long long now = clock64(); '
             'p_acc[i] += now - p_t; p_t = now; }\n'),
            ("  const unsigned lt_mask = (1u << lane) - 1u;\n  if (tid == 0) s_stage = 0;\n",
             "  const unsigned lt_mask = (1u << lane) - 1u;\n  if (tid == 0) s_stage = 0;\n"
             "  unsigned long long p_t = clock64(), p_acc[6] = {0, 0, 0, 0, 0, 0};\n"),
            ("    const long long pbase = start[s_part];\n",
             "    MARK(0)\n    const long long pbase = start[s_part];\n"),
            ("      const int nt = (nev + tile - 1) / tile;\n",
             "      MARK(1)\n      const int nt = (nev + tile - 1) / tile;\n"),
            ("        cp_async_wait(stages - 1);\n        __syncthreads();\n",
             "        cp_async_wait(stages - 1);\n        __syncthreads();\n        MARK(2)\n"),
            ("        const int st = t % stages;\n        const int e0 = t * tile;\n"
             "        const int nr = nev - e0 < tile ? nev - e0 : tile;\n        const float* rows",
             "        MARK(3)\n        const int st = t % stages;\n        const int e0 = t * tile;\n"
             "        const int nr = nev - e0 < tile ? nev - e0 : tile;\n        const float* rows"),
            ("        if (tid < nq && fresh < s_thresh[tid]) s_thresh[tid] = fresh;\n",
             "        MARK(4)\n        if (tid < nq && fresh < s_thresh[tid]) s_thresh[tid] = fresh;\n"),
            ("      if (lane == 0) atomicExch(lock, prev + 1);\n    }\n    __syncthreads();\n  }\n}\n",
             "      if (lane == 0) atomicExch(lock, prev + 1);\n    }\n    __syncthreads();\n    MARK(5)\n  }\n"
             "  if (tid == 0) for (int i = 0; i < 6; ++i) atomicAdd(&g_prof[i], p_acc[i]);\n}\n"),
            ("CLIMBER_API int climber_refine_group(int n, int k) {",
             "CLIMBER_API int climber_refine_profile(unsigned long long* out) {\n"
             "  unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
             "  cudaMemcpyFromSymbol(out, g_prof, sizeof(zero));\n"
             "  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));\n}\n\n"
             "CLIMBER_API int climber_refine_group(int n, int k) {")]),
        # its ring shape and pool room, each against the build's
        "pm_ring_32x3": ("refine_topk.cu", [
            ("{{32, 2}, {16, 3}, {32, 3}, {16, 2}, {8, 2}, {4, 2}}",
             "{{32, 3}, {32, 2}, {16, 3}, {16, 2}, {8, 2}, {4, 2}}"),
            ("  for (int want = 16; want >= 1; want -= 15) {",
             "  for (int want = 12; want >= 1; want -= 11) {")]),
        "pm_room_k": ("refine_topk.cu", [
            ("  int room = k / 2 > kNew ? k / 2 : kNew;", "  int room = k > kNew ? k : kNew;")]),
        # units of 8 rows x 4 queries, the tile invariant's check taken out:
        # at n = 2,048 the ring's tiles are 4 rows, so a unit of the last
        # tile reads past the block's shared memory (a fault; built only
        # where --variants names it); and the same units with tiles of at
        # least 8 rows
        "pm_unit_8x4": ("refine_topk.cu", UNIT_8X4 + [
            ('static_assert(tiles_hold_units(), "every ring tile holds whole units of kRw rows");\n',
             "")]),
        "pm_unit_8x4_tile8": ("refine_topk.cu", UNIT_8X4 + [
            ("{{32, 2}, {16, 3}, {32, 3}, {16, 2}, {8, 2}, {4, 2}}",
             "{{32, 2}, {16, 3}, {32, 3}, {16, 2}, {8, 2}}")]),
        # the committed kernel with its shared- and scratch-memory indices
        # checked: a block whose layout passes its dynamic shared memory, a
        # unit past the ring, a pool, the list of kept slots, the merge
        # stage or the merge block's keys past their room, or a segment
        # past the plan traps (CUDA error 719)
        "pm_checked": ("refine_topk.cu", [
            ("    int* ev_d = reinterpret_cast<int*>(ev_m + kEv);\n",
             "    int* ev_d = reinterpret_cast<int*>(ev_m + kEv);\n"
             "    {\n      unsigned dyn;\n"
             '      asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));\n'
             "      if (reinterpret_cast<unsigned char*>(ev_d + kEv) - smem > dyn) __trap();\n"
             "      if (nq < 1 || nq > kMaxGroup) __trap();\n    }\n"),
            ("          const float* xr = rows + r0 * n_pad;\n",
             "          if (st * tile + r0 + kRw > stages * tile) __trap();\n"
             "          const float* xr = rows + r0 * n_pad;\n"),
            ("              const int pos = atomicAdd(&s_cnt[g], 1);\n",
             "              const int pos = atomicAdd(&s_cnt[g], 1);\n"
             "              if (pos >= pk) __trap();\n"),
            ("          if (m) {\n            ev_c[pos] = c0 + u * kThreads + tid;\n",
             "          if (m) {\n            if (pos >= kEv) __trap();\n"
             "            ev_c[pos] = c0 + u * kThreads + tid;\n"),
            ("        __syncwarp();\n        if (total > k) {\n",
             "        __syncwarp();\n        if (total > 2 * k) __trap();\n"
             "        if (total > k) {\n"),
            ("    if (x != kEmpty) a[pos] = x;\n",
             "    if (x != kEmpty && pos >= (keys_at > p2 ? keys_at : p2)) __trap();\n"
             "    if (x != kEmpty) a[pos] = x;\n"),
            ("      if (keep) b[pos] = a[i];\n",
             "      if (keep && pos >= static_cast<unsigned>(p2)) __trap();\n"
             "      if (keep) b[pos] = a[i];\n"),
            ("      seg[pos] = make_int2(q * mp + s,",
             "      if (pos >= static_cast<unsigned>(qn) * mp) __trap();\n"
             "      seg[pos] = make_int2(q * mp + s,")]),
    },
    "pairwise_l2": {
        # the first redesign's ring: 32-deep slices, three of them
        "k32_s3": ("l2.cu", [
            ("constexpr int kPK = 64;", "constexpr int kPK = 32;"),
            ("constexpr int kPStages = 2;", "constexpr int kPStages = 3;")]),
        # deeper rings of shallower slices: more loads in flight
        "k32_s4": ("l2.cu", [
            ("constexpr int kPK = 64;", "constexpr int kPK = 32;"),
            ("constexpr int kPStages = 2;", "constexpr int kPStages = 4;")]),
        "k16_s6": ("l2.cu", [
            ("constexpr int kPK = 64;", "constexpr int kPK = 16;"),
            ("constexpr int kPStages = 2;", "constexpr int kPStages = 6;")]),
        # 512 threads and 512-row tiles, 32-deep slices (16 warps per SM)
        "warps16_k32": ("l2.cu", [
            ("constexpr int kPWarpsC = 4;", "constexpr int kPWarpsC = 8;"),
            ("constexpr int kPK = 64;", "constexpr int kPK = 32;")]),
        # two 256-thread blocks per SM: 16-deep slices, a 2-slice ring
        "blocks2_k16": ("l2.cu", [
            ("constexpr int kPK = 64;", "constexpr int kPK = 16;"),
            ("constexpr int kPMinBlocks = 1;", "constexpr int kPMinBlocks = 2;")]),
        # an 8 x 16 register tile (512-row tiles), 32-deep slices
        "j16_k32": ("l2.cu", [
            ("constexpr int kPJ = 8;", "constexpr int kPJ = 16;"),
            ("constexpr int kPK = 64;", "constexpr int kPK = 32;")]),
        # 384 threads, 384-row tiles, 32-deep slices (12 warps per SM)
        "warps12_k32": ("l2.cu", [
            ("constexpr int kPWarpsC = 4;", "constexpr int kPWarpsC = 6;"),
            ("constexpr int kPK = 64;", "constexpr int kPK = 32;")]),
        # FMAs ordered query-major (each a[i] against the kPJ candidates)
        "ij_order": ("l2.cu", [
            ("""#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const float bj = lane_of(b[j], u);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], bj, acc[i][j]);
        }""", """#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) acc[i][j] = fmaf(a[i], lane_of(b[j], u), acc[i][j]);""")]),
        "unroll4": ("l2.cu", [
            ("#pragma unroll\n    for (int kq = 0; kq < kPK / 4; ++kq) {",
             "#pragma unroll 4\n    for (int kq = 0; kq < kPK / 4; ++kq) {")]),
        # probes: no barrier before a slice is read (a race, timing only);
        # no copies after the first slices (stale data); no |x|^2 pass;
        # almost no output stores (the FMAs stay)
        "no_barrier": ("l2.cu", [
            ("    cp_async_wait<kPStages - 2>();\n    __syncthreads();",
             "    cp_async_wait<kPStages - 2>();")]),
        "no_loads": ("l2.cu", [
            ("    if (t + kPStages - 1 < steps)\n      load_slice<VEC>",
             "    if (t + kPStages - 1 < 0)\n      load_slice<VEC>")]),
        "no_norm": ("l2.cu", [
            ("    for (int r = 0; r < kPNorm; ++r) {\n      const float4* row",
             "    for (int r = 0; r < 0; ++r) {\n      const float4* row")]),
        "few_stores": ("l2.cu", [
            ("if (c0 + cl < cn) orow[cl] =", "if (c0 + cl < cn && acc[i][j] == 1234.5f) orow[cl] =")]),
    },
    "paa": {
        # the ring's depth, a tile's size and the sum's unrolling
        "stages3": ("paa.cu", [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
        "stages4": ("paa.cu", [("constexpr int kStages = 2;", "constexpr int kStages = 4;")]),
        "tile16k": ("paa.cu", [("constexpr int kTileBytes = 32768;",
                                "constexpr int kTileBytes = 16384;")]),
        "tile16k_stages4": ("paa.cu", [
            ("constexpr int kStages = 2;", "constexpr int kStages = 4;"),
            ("constexpr int kTileBytes = 32768;", "constexpr int kTileBytes = 16384;")]),
        "unroll8": ("paa.cu", [("      for (int j = 0; j < cps; ++j) acc",
                                "#pragma unroll 8\n      for (int j = 0; j < cps; ++j) acc")]),
        # each tile copied by one 1-D TMA bulk copy (one thread issues it,
        # an mbarrier per ring slot), packed; 16-byte path only
        "tma_bulk": ("paa.cu", [
            ("template <int V>\n__global__ void __launch_bounds__(kThreads)\npaa_kernel(",
             PAA_TMA + "template <int V>\n__global__ void __launch_bounds__(kThreads)\n"
             "paa_kernel_cp_async("),
            ("static_cast<size_t>(kStages) * P * cps * V;",
             "static_cast<size_t>(kStages) * P * cps * V + kStages * 8;"),
            ("  return launch<4>(x, out, segs, seg, s);",
             "  return static_cast<int>(cudaErrorNotSupported);")]),
        # probes of what each part buys: the packed layout (bank conflicts in
        # the sum); segments at an odd chunk stride (no conflicts, scattered
        # copies); the copies alone, nothing summed or written; the sums
        # without their stores
        "packed": ("paa.cu", [(XM_SWIZZLED, "  const int xm = 0;")]),
        "padded": ("paa.cu", [
            ("  for (int g = threadIdx.x; g < total; g += kThreads)\n"
             "    cp_async<V>(buf + (g ^ ((g >> ws) & xm)), src + g);",
             """  int p = threadIdx.x / cps, c = threadIdx.x - p * cps;
  for (int g = threadIdx.x; g < total; g += kThreads) {
    cp_async<V>(buf + p * (cps | 1) + c, src + g);
    c += kThreads % cps;
    const bool wrap = c >= cps;
    p += kThreads / cps + wrap;
    c -= wrap ? cps : 0;
  }"""),
            (XM_SWIZZLED, "  const int xm = 0;"),
            ("  const int slot = P * cps;", "  const int slot = P * (cps | 1);"),
            ("      const T* s = buf + p * cps;", "      const T* s = buf + p * (cps | 1);"),
            ("static_cast<size_t>(kStages) * P * cps * V;",
             "static_cast<size_t>(kStages) * P * (cps | 1) * V;")]),
        "copy_only": ("paa.cu", [
            ("for (int p = threadIdx.x; p < np; p += kThreads) {",
             "for (int p = threadIdx.x; p < 0 * np; p += kThreads) {")]),
        "no_store": ("paa.cu", [
            ("      out[tile * P + p] = acc / static_cast<float>(seg);",
             "      if (acc == 1234.5f) out[tile * P + p] = acc / static_cast<float>(seg);")]),
    },
}
PROBES = {"packed", "padded", "copy_only", "no_store", "tags_only", "rows_no_insert", "no_final_sort", "merge_only", "setup_only",
          "keep_all", "pm_tags_only", "pm_no_score", "pm_no_sort", "no_norm", "few_stores", "no_barrier", "no_loads"}
# variants that fault by design: built only where --variants names them
FAULTS = {"pm_unit_8x4"}
CFG_SEED_QUERIES = 256


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def variant_sources(kernel: str, csrc: Path, only=None):
    """name -> {file: text} of the variants whose anchors all exist (of
    ``only``'s names where given)."""
    out, skipped = {}, []
    for name, (fname, edits) in EDITS[kernel].items():
        if only is not None and name not in only:
            continue
        text = (csrc / fname).read_text()
        if not all(text.count(a) == 1 for a, _ in edits):
            skipped.append(name)
            continue
        for a, b in edits:
            text = text.replace(a, b)
        out[name] = {fname: text}
    return out, skipped


def build_all(builds: dict, root: Path, only=None) -> dict:
    """builds: name -> (csrc dir, {file: text} overrides).  One nvcc per
    build, all started together, over every source or the ``only`` ones;
    returns name -> (CDLL, ptxas log)."""
    nvcc = _lib.find_nvcc()
    procs = {}
    for name, (csrc, override) in builds.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for p in sorted(csrc.glob("*.cu*")):
            (d / p.name).write_text(override.get(p.name, p.read_text()))
        cmd = [nvcc, *_lib.NVCC_FLAGS, "-shared", "-I", str(d),
               *sorted(str(p) for p in d.glob("*.cu") if only is None or p.name in only),
               "-o", str(d / "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        text = (root / name / "refine_topk.cu").read_text()
        # a build of the query-major design alone: its first version takes a
        # fixed number of blocks per query, its redesign the most a query
        # may get
        lib.query_major = "climber_refine_group" not in text
        lib.balanced = "refine_plan_kernel" in text
        # a build that takes each partition's start and extent (a flat store)
        lib.ragged = "const long long* start, const int* extent" in text
        for fn_name, (restype, argtypes) in _lib._SIGNATURES.items():
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = (restype, argtypes) if lib.ragged \
                    else DENSE_SIGNATURES.get(fn_name, (restype, argtypes))
        if lib.query_major:
            fn = lib.climber_refine_topk
            fn.restype, fn.argtypes = QUERY_MAJOR_REFINE
        built[name] = (lib, log)
    return built


# climber_refine_topk of the query-major designs (an older tree's build)
QUERY_MAJOR_REFINE = (ctypes.c_int, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])


# the entries of a build that takes dense [P, cap] stores only (an older tree)
DENSE_SIGNATURES = {
    "climber_refine_topk": (ctypes.c_int, [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p]),
    "climber_refine_topk_query_major": (ctypes.c_int, [ctypes.c_void_p] * 12
                                        + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
}


def call_refine(lib, store, qs, sp, lo, hi, k: int, design=None, group=None):
    """``(d2, gid)`` of a build of ``refine_topk.cu`` on a partition-sorted
    plan, through that build's own C interface: by the package's rule for
    which design a plan takes, or ``design`` ("query" / "partition"; an
    older tree has the query-major design only), with at most ``group``
    queries an item in the partition-major one (None: the most).  A build
    that takes dense stores only refuses a ragged one."""
    from repro_torch.kernels.refine_topk import PARTITION_MAJOR_MIN, flat_store, plan_lists
    dev = qs.device
    qn, n = qs.shape
    mp = sp.shape[1]
    d2 = torch.empty((qn, k), dtype=torch.float32, device=dev)
    gid = torch.empty((qn, k), dtype=torch.int32, device=dev)
    plan = (qs.data_ptr(), sp.data_ptr(), lo.data_ptr(), hi.data_ptr())
    if lib.ragged:
        rows, norms, dfs, gids, lay = flat_store(store.data, store.norms, store.rec_dfs,
                                                 store.rec_gid, store.ragged)
        p, cap = lay.start.shape[0], lay.cap
        ptrs = tuple(t.data_ptr() for t in (rows, norms, dfs, gids, lay.start, lay.extent)) + plan
    else:
        if store.ragged is not None:
            raise ValueError("this build takes dense [P, cap, n] stores only")
        p, cap = store.norms.shape
        ptrs = (store.data.data_ptr(), store.norms.data_ptr(), store.rec_dfs.data_ptr(),
                store.rec_gid.data_ptr()) + plan
    stream = _lib.stream(dev)
    if design is None:
        design = "query" if qn * mp < PARTITION_MAJOR_MIN * p else "partition"
    if lib.query_major or design == "query":
        merge_smem = (lib.climber_refine_merge_smem if lib.query_major
                      else lib.climber_refine_partial_merge_smem)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        s = 64 if lib.balanced else max(1, min(64, -(-4 * sms // qn)))
        while s > 1 and merge_smem(s, k) > _lib.SMEM_LIMIT:
            s -= 1
        if lib.query_major:
            partial = torch.empty(qn * (s * k + 2), dtype=torch.int64, device=dev)
            _lib.check(lib.climber_refine_topk(*ptrs, partial.data_ptr(), d2.data_ptr(),
                                               gid.data_ptr(), qn, mp, cap, n, k, s, stream),
                       "refine build")
            return d2, gid
        partial = torch.empty((lib.climber_refine_partial_scratch_bytes(qn, p, k, s) + 7) // 8,
                              dtype=torch.int64, device=dev)
        stats = torch.empty(2, dtype=torch.int64, device=dev)
        _lib.check(lib.climber_refine_topk_query_major(
            *ptrs, partial.data_ptr(), stats.data_ptr(), d2.data_ptr(), gid.data_ptr(), qn,
            mp, p, cap, n, k, s, stream), "refine build")
        return d2, gid
    group = min(group or 1 << 30, lib.climber_refine_group(n, k))
    lists = plan_lists(qn, mp, p, n, k, group)
    scratch = torch.empty((lib.climber_refine_scratch_bytes(qn, mp, p, k, lists, group) + 7)
                          // 8, dtype=torch.int64, device=dev)
    stats = torch.empty(5, dtype=torch.int64, device=dev)
    _lib.check(lib.climber_refine_topk(*ptrs, scratch.data_ptr(), stats.data_ptr(),
                                       d2.data_ptr(), gid.data_ptr(), qn, mp, p, cap, n,
                                       k, lists, group, stream), "refine build")
    return d2, gid


def ptxas_of(log: str, entry: str) -> dict:
    """Registers and spills of each entry whose mangled name holds ``entry``."""
    info, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            name = ln.split("'")[1]
            cur = name if entry in name else None
            if cur:
                info[cur] = {}
        elif cur and "bytes spill stores" in ln:
            f = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
            info[cur].update(spill_stores=f[1], spill_loads=f[2])
        elif cur and "Used" in ln and "registers" in ln:
            info[cur]["registers"] = int(ln.split("Used")[1].split()[0])
    return info


def timed(fn, names, iters=20):
    """(event ms per call, {kernel-name fragment: profiler device ms per call})."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    dev = {}
    for e in pr.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for frag in names:
                if frag in e.name:
                    dev[frag] = dev.get(frag, 0.0) + e.time_range.elapsed_us() / 1e3 / 5
    return ms, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("refine_topk", "pairwise_l2", "paa", "all"),
                    default="all")
    ap.add_argument("--csrc", default=str(_lib.CSRC))
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num", type=int, default=1 << 22)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=None,
                    help="comma-separated edits to build (default: all but FAULTS)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "kernel_variants.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1

    from repro_torch.core.index import build_index
    from repro_torch.core.query import plan as plan_queries
    from repro_torch.data import make_dataset, make_queries
    from repro_torch.kernels.l2 import pairwise_l2_plain
    from repro_torch.kernels.paa_kernel import paa_sequential
    from repro_torch.kernels.refine_topk import masked_distances, refine_work, topk_flat
    from repro_torch.utils.config import ClimberConfig

    kernels = (("refine_topk", "pairwise_l2", "paa") if args.kernel == "all"
               else (args.kernel,))
    csrc = Path(args.csrc).resolve()
    builds = {"kernel": (csrc, {})}
    if args.parent_csrc:
        builds["parent"] = (Path(args.parent_csrc).resolve(), {})
    skipped = {}
    only = set(args.variants.split(",")) - {""} if args.variants is not None else None
    for kern in kernels:
        srcs, skipped[kern] = variant_sources(
            kern, csrc, only if only is not None else set(EDITS[kern]) - FAULTS)
        builds.update({f"{kern}:{v}": (csrc, o) for v, o in srcs.items()})
    built = build_all(builds, ROOT / "build" / "kernel_variants",
                      only={"paa.cu"} if kernels == ("paa",) else None)

    dev = torch.device("cuda", 0)
    cfg = ClimberConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = make_dataset("randomwalk", args.num, cfg.series_len, generator=gen)
    stream = _lib.stream(dev)
    report = {"card": smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
              "csrc": str(csrc), "parent_csrc": args.parent_csrc,
              "skipped_edits": skipped, "ptxas": {}}
    n = cfg.series_len
    for name, (_, log) in built.items():
        report["ptxas"][name] = {**ptxas_of(log, "refine"), **ptxas_of(log, "pairwise_l2"),
                                 **ptxas_of(log, "paa")}

    def rounds(cases, names, inputs_of, run, frags):
        """Time every (case, build) in interleaved rounds."""
        out = {c: {b: {"ms": [], "device_ms": []} for b in names} for c in cases}
        for _ in range(args.rounds):
            for c in cases:
                for b in names:
                    lib = built[b][0] if b in built else None
                    ms, d = timed(lambda: run(lib, *inputs_of(c)), frags)
                    out[c][b]["ms"].append(ms)
                    out[c][b]["device_ms"].append(d)
        return out

    if "refine_topk" in kernels:
        index = build_index(data, cfg, device=dev, generator=gen)
        store = index.store
        queries = make_queries(data, CFG_SEED_QUERIES, generator=gen)
        plans = {}

        def add_plan(label, st, qs, sp, lo, hi, k):
            """A partition-sorted plan with its counts and byte bound."""
            nq, nn = qs.shape
            live_w = max(1, int((sp >= 0).sum(1).max()))
            work = refine_work(st.rec_dfs, st.rec_gid, sp[:, -live_w:],
                               lo[:, -live_w:], hi[:, -live_w:])
            nbytes = (work["unique_kept_records"] * (4 * nn + 4) + work["live_slots"] * 8
                      + nq * nn * 4 + 3 * nq * sp.shape[1] * 4 + nq * k * 8)
            flops = work["kept_pairs"] * (2 * nn + 3)
            bound = max(nbytes / 3.35e12, flops / 67e12) * 1e3
            plans[label] = (qs, sp, lo, hi, st, k,
                            dict(work, mp=sp.shape[1], live_width=live_w, bound_ms=bound))

        for label, qs, variant in (("adaptive_q0-63", queries[:64], "adaptive"),
                                   ("adaptive_q64-127", queries[64:128], "adaptive"),
                                   ("od_smallest_q0-63", queries[:64], "od_smallest")):
            qs = qs.contiguous()
            p4r, _ = index.featurize(qs)
            qp = plan_queries(index, p4r, variant=variant)
            order = torch.argsort(qp.sel_part, dim=-1, stable=True)
            sp, lo, hi = (torch.gather(t, 1, order).to(torch.int32).contiguous()
                          for t in (qp.sel_part, qp.sel_lo, qp.sel_hi))
            add_plan(label, store, qs, sp, lo, hi, cfg.k)
        # stand-ins of two more shapes (seeded normal rows, not their data):
        # the kNN-LM plan (Q = 64, MP = 864 with 40 live entries, cap 1,749,
        # n = 2,048, K = 16) and the dry-run slot (50 queries x 16 whole
        # partitions of 166 x 3,000 x 256, K = 500)
        for label, p_, cap_, n_, q_, mp_, live_, k_ in (
                ("lm_shape", 240, 1749, 2048, 64, 864, 40, 16),
                ("dryrun_slot", 166, 3000, 256, 50, 16, 16, cfg.k)):
            g_s = torch.Generator(device=dev).manual_seed(args.seed + 300 + n_)
            st = types.SimpleNamespace(
                data=torch.randn((p_, cap_, n_), generator=g_s, device=dev),
                rec_dfs=torch.randint(0, 4, (p_, cap_), generator=g_s, device=dev,
                                      dtype=torch.int32),
                rec_gid=torch.arange(p_ * cap_, device=dev, dtype=torch.int32).view(p_, cap_))
            st.norms = (st.data.double() ** 2).sum(-1).float()
            qs = torch.randn((q_, n_), generator=g_s, device=dev)
            parts = torch.stack([torch.randperm(p_, generator=g_s, device=dev)[:live_]
                                 for _ in range(q_)]).sort(dim=1).values
            sp = torch.full((q_, mp_), -1, dtype=torch.int32, device=dev)
            sp[:, mp_ - live_:] = parts.to(torch.int32)
            whole = label == "dryrun_slot"
            lo = torch.where(sp >= 0, 0 if whole else torch.randint(
                0, 2, sp.shape, generator=g_s, device=dev), 0).to(torch.int32)
            hi = torch.where(sp >= 0, 4 if whole else lo + torch.randint(
                1, 3, sp.shape, generator=g_s, device=dev), 0).to(torch.int32)
            add_plan(label, st, qs.contiguous(), sp, lo, hi, k_)

        def run_refine(lib, qs, sp, lo, hi, st, k):
            return call_refine(lib, st, qs, sp, lo, hi, k)

        names = [b for b in built if b in ("kernel", "parent") or b.startswith("refine_topk:")]
        checks = {}
        for label, (qs, sp, lo, hi, st, k, info) in plans.items():
            live_w, cap, nn = info["live_width"], st.norms.shape[1], qs.shape[1]
            qc = max(1, int(2e9 // (live_w * cap * nn * 4)))
            outs = [topk_flat(*masked_distances(
                st.data, st.norms, st.rec_dfs, st.rec_gid, qs[a:a + qc],
                sp[a:a + qc, -live_w:], lo[a:a + qc, -live_w:], hi[a:a + qc, -live_w:]), k)
                for a in range(0, qs.shape[0], qc)]
            d2_p, g_p = torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
            tol = 1e-5 * ((qs * qs).sum(-1, keepdim=True) + float(st.norms.max()))
            ref = run_refine(built["kernel"][0], qs, sp, lo, hi, st, k)
            checks[label] = {}
            for b in names:
                if b.split(":")[-1] in PROBES:
                    continue
                print(f"refine check: {label} {b}", file=sys.stderr, flush=True)
                d2, g = run_refine(built[b][0], qs, sp, lo, hi, st, k)
                torch.cuda.synchronize()
                err = (d2 - d2_p).abs()
                far = 0
                for i in (g != g_p).any(1).nonzero()[:, 0].tolist():
                    extra = ~torch.isin(g[i], g_p[i])
                    far += int(((d2[i][extra] - d2_p[i, -1]).abs() > tol[i]).any())
                checks[label][b] = {"max_abs_err": float(err.max()),
                                    "within_rule": bool((err <= tol).all()) and far == 0,
                                    "equal_to_kernel": bool(torch.equal(d2, ref[0])
                                                            and torch.equal(g, ref[1]))}
        # every build forced to the partition-major design on every plan,
        # with one query an item and with the most, against the package
        # kernel's build forced alike, bit for bit
        forced = {}
        for label, (qs, sp, lo, hi, st, k, info) in plans.items():
            forced[label] = {}
            for grp in (1, None):
                ref = call_refine(built["kernel"][0], st, qs, sp, lo, hi, k, "partition", grp)
                for b in names:
                    if b == "parent" or b.split(":")[-1] in PROBES:
                        continue
                    print(f"partition-major check: {label} group {grp} {b}", file=sys.stderr,
                          flush=True)
                    d2, g = call_refine(built[b][0], st, qs, sp, lo, hi, k, "partition", grp)
                    torch.cuda.synchronize()
                    forced[label][f"{b} group={grp}"] = bool(
                        torch.equal(d2, ref[0]) and torch.equal(g, ref[1]))
        report["refine_topk_forced_partition_major"] = forced
        print("partition-major forced, equal to the kernel: " + json.dumps(forced), flush=True)
        times = rounds(list(plans), names, lambda c: plans[c][:6], run_refine,
                       ("refine_partial", "refine_part_", "refine_merge", "refine"))
        report["refine_topk"] = {"plans": {c: plans[c][6] for c in plans},
                                 "checks": checks, "times": times}
        del index, store, plans

    if "pairwise_l2" in kernels:
        g2 = torch.Generator(device=dev).manual_seed(args.seed + 100)
        q64 = data[torch.randperm(data.shape[0], generator=g2, device=dev)[:64]].contiguous()
        x_c = data[: 1 << 20]

        def run_l2(lib, q, x):
            out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32, device=dev)
            _lib.check(lib.climber_pairwise_l2(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                               q.shape[0], x.shape[0], n, stream),
                       "pairwise_l2 variant")
            return out

        names = [b for b in built if b in ("kernel", "parent") or b.startswith("pairwise_l2:")]
        want = pairwise_l2_plain(q64, x_c)
        tol = 1e-5 * ((q64 * q64).sum(-1, keepdim=True) + (x_c * x_c).sum(-1)[None, :])
        ref = run_l2(built["kernel"][0], q64, x_c)
        checks = {}
        for b in names:
            if b.split(":")[-1] in PROBES:
                continue
            got = run_l2(built[b][0], q64, x_c)
            err = (got - want).abs()
            checks[b] = {"max_abs_err": float(err.max()),
                         "within_rule": bool((err <= tol).all()),
                         "equal_to_kernel": bool(torch.equal(got, ref))}
        del want, tol, ref
        times = rounds(["64x2^20"], names, lambda c: (q64, x_c), run_l2, ("pairwise_l2",))
        report["pairwise_l2"] = {"shape": "[64,256] x [1048576,256]",
                                 "bound_ms": 2 * 64 * (1 << 20) * n / 67e12 * 1e3,
                                 "checks": checks, "times": times}

    paa_ok = True
    if "paa" in kernels:
        w = cfg.paa_segments
        g3 = torch.Generator(device=dev).manual_seed(args.seed + 200)
        cases = {f"[{data.shape[0]},{n}]": data,
                 "[262144,2048]": torch.randn((1 << 18, 2048), generator=g3, device=dev),
                 "[64,256]": data[torch.randperm(data.shape[0], generator=g3,
                                                 device=dev)[:64]].contiguous()}

        def run_paa(lib, x):
            b, nx = x.shape
            if lib is None:                           # the library call
                return x.view(b, w, nx // w).mean(-1)
            out = torch.empty((b, w), dtype=torch.float32, device=dev)
            _lib.check(lib.climber_paa(x.data_ptr(), out.data_ptr(), b, nx, w, stream),
                       "paa variant")
            return out

        names = [b for b in built if b in ("kernel", "parent") or b.startswith("paa:")]
        checks = {}
        for c, x in cases.items():
            ref = run_paa(built["kernel"][0], x)
            k = min(x.shape[0], 8192)
            rows = torch.arange(k, device=dev) * x.shape[0] // k
            seq = bool(torch.equal(ref[rows].cpu(), paa_sequential(x[rows].cpu(), w)))
            checks[c] = {"kernel": {"equal_to_paa_sequential": seq,
                                    "sampled_rows": rows.numel()},
                         "library": "timed only"}
            paa_ok &= seq
            for b in names:
                if b != "kernel" and b.split(":")[-1] not in PROBES:
                    eq = bool(torch.equal(run_paa(built[b][0], x), ref))
                    checks[c][b] = {"equal_to_kernel": eq}
                    paa_ok &= eq
        times = rounds(list(cases), names + ["library"], lambda c: (cases[c],), run_paa,
                       ("paa", "reduce"))
        report["paa"] = {
            "bound_ms": {c: 4 * x.shape[0] * (x.shape[1] + w) / 3.35e12 * 1e3
                         for c, x in cases.items()},
            "checks": checks, "times": times}
        del cases

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    for kern in kernels:
        if kern not in report:
            continue
        r = report[kern]
        print(f"== {kern}: skipped edits {skipped[kern]}")
        for c, per in r["times"].items():
            print(f"  {c}: {json.dumps(r.get('plans', {}).get(c, r.get('bound_ms', {}).get(c, {})))}")
            for b, t in per.items():
                chk = (r["checks"].get(c, r["checks"]) or {}).get(b, "probe")
                print(f"    {b:32s} ms {['%.4f' % v for v in t['ms']]} "
                      f"device {[{a: round(x, 4) for a, x in d.items()} for d in t['device_ms']]} "
                      f"{chk}")
    for name, p in report["ptxas"].items():
        print(f"ptxas {name}: {p}")
    print(report["card"])
    return 0 if paa_ok else 1


if __name__ == "__main__":
    sys.exit(main())
