// Fused refine: masked squared ED + k-best, straight off the partition
// store, with no gather and no [Q, MP, cap] distance tensor.
//
// Replaces the Pallas kernel repro/kernels/refine_topk.py::refine_topk
// (_refine_topk_kernel, the pallas_call at repro/kernels/refine_topk.py:189).
// For query q and plan entry s (the plan sorted by partition id, pads first)
// the candidates are the cap slots of partition sel_part[q, s]; slot c has
// the flat index f = s * cap + c.  A record is kept iff gid >= 0,
// sel_lo <= dfs < sel_hi, and no earlier entry of the same partition covers
// it (the segment dedupe of core/refine.py).  Its squared distance is
// max(|q|^2 - 2 q.x + |x|^2, 0).  The output is the k best by the key
// (d2, f): ties go to the lowest flat index, as jax.lax.top_k gives.
//
// Bound by HBM bytes: each distinct kept record's row and norm read once
// (4n + 4 bytes), plus the tags.  On a tick of the benchmark's cells
// (4,096 queries over 4,244 partitions of cap 6,541, n = 256, k = 500) a
// planned partition is named by 8 (adaptive) to 22 (spend 4) queries, so
// the distinct kept records are 4.8x to 8.9x fewer than the kept
// (query, record) pairs.
//
// Two designs, which give the same bits.  The query-major one (below, in
// namespace qm; the second of two query-major designs) gives each query
// blocks in proportion to its live slots (grid (splits, Q), sharing a chunk
// counter): 2,048-slot tag passes, then the kept rows streamed 8 per warp
// with all their loads in flight, and a merge of the query's sorted partial
// lists by merge path.  Its first version (a fixed number of blocks per
// query, 256-slot tiles of tag test, rows and key insert) took 0.50-0.52
// ms on the smoke's adaptive batch (Q = 64, 8 live entries, cap 4,026: a
// 0.138 ms bound); this one 0.26-0.27 ms there, but 17.6-17.7 ms (adaptive)
// and 42.9-46.8 ms (spend 4) on the cells' ticks: every block read its own
// query's kept rows, 1,028 bytes a kept pair, at 2.9 TB/s, so a record that
// 8 or 22 queries planned crossed HBM 8 or 22 times (tools/refine_cells.py,
// one H100).  The wrapper takes it where the plan's partitions have few
// entries (Q * MP / P below PARTITION_MAJOR_MIN): there its fewer fixed
// costs win.
//
// The partition-major design: five kernels and two memsets on one stream,
// no host sync.
//   * refine_count_kernel (a warp per plan row): each (query, partition)
//     segment of the row (its entries of one partition, contiguous in the
//     sorted row) counted into its partition, and each query's segments.
//   * refine_scan_kernel (one block): the partitions' segment offsets, and
//     the work items: each planned partition's segments split evenly into
//     items of at most `group` queries (as many as the block's shared memory
//     holds beside its ring of rows: 19 at n = 256, k = 500).
//     refine_scatter_kernel (a warp per plan row) places each segment in
//     its partition's bucket with its ordinal in its row.
//   * refine_part_kernel, a persistent grid taking items from a counter.  A
//     block orders its item's queries by their first interval, tests the
//     partition's tags for all of them at once (a bit per query), lists the
//     slots some query keeps, and streams those rows into shared memory
//     once with cp.async, in a ring of tiles (32 rows x 2 at n = 256).  Each
//     warp scores units of 4 rows x 8 queries from shared memory, the
//     queries' float4 in registers: lane l sums float4 l, l + 32, ... of
//     each pair with fmaf in the order of the query-major designs, and a
//     transposed butterfly (16 + 8 + 4 + 2 + 1 shuffles for 32 pairs, each
//     level pairing the lanes warp_sum pairs) leaves pair l's dot on lane l
//     with warp_sum's bits.  So every distance keeps the bits of the earlier
//     designs.  A key goes to its query's pool if it is below the query's
//     bound: the k-th key of any k of the query's keys kept so far, shared by
//     all blocks through an atomicMin in the scratch and re-read each tile.
//     A pool that cannot take another tile's keys is cut to its k best (the
//     k-th key found by a warp's radix select, 8-bit digits from the first
//     byte the keys do not share), which lowers the bound.  At the item's
//     end each query's k best (unsorted, empty-padded) go to one of its
//     `lists` lists in device memory (the segment's ordinal modulo `lists`);
//     a list another segment wrote first is cut with it to the k best of
//     both under a per-list lock.
//   * refine_merge_kernel, grid Q: the keys of the query's lists gathered,
//     the k-th found by the same radix select, the k best bitonic-sorted;
//     then (d2, gid), with 3.4e38 / -1 past the pool.
// On the cells' ticks (tools/refine_cells.py, one H100) it takes 10.3 ms
// (adaptive) and 22.6 ms (spend 4); a block spends 42-50% of its cycles
// scoring, 21-26% waiting on the ring, 9-13% cutting pools, 8-9% on tags and
// 8-9% writing lists.  The key is exact and a query's keys are distinct, so
// the answer does not depend on the items, the lists, the order in which
// blocks take items, lower the bounds or take a list's lock.
//
// Both designs write the plan's sharing to `stats`, counted on the card:
// its live (query, partition) segments and its distinct planned partitions,
// the partition-major design in its count and scan kernels, the
// query-major one in its merge kernel (a flag a partition).
#include "climber_kernels.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kScanPer = 4;               // tag pairs in flight per thread
constexpr int kScan = kThreads * kScanPer;   // slots per tag pass
constexpr int kEv = 1024;                 // listed slots held at once
constexpr int kGw = 8;                    // queries of a warp's unit
constexpr int kRw = 4;                    // rows of a warp's unit
constexpr int kMaxGroup = 32;             // queries an item holds at most
static_assert(kMaxGroup <= kGw * kWarps, "a warp scores one block of kGw queries");
constexpr int kNew = 64;                  // new keys a pool takes at least
constexpr int kMergeStatic = 2048;        // static shared memory of the merge block, at most
constexpr int kEnt = 4;                   // entries of a segment kept in smem
constexpr int kMergeThreads = 512;
constexpr int kStatic = 3072;             // bytes of static shared memory, at most
constexpr unsigned kLocked = 0x80000000u;
constexpr u64 kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr float kPadDist = 3.4e38f;

// ctr: the call's counters (u64)
constexpr int kCtrNext = 0;               // next item to take
constexpr int kCtrItems = 1;              // items
constexpr int kCtrPairs = 2;              // live (query, partition) segments
constexpr int kCtrParts = 3;              // distinct planned partitions
constexpr int kCtrWords = 8;

__device__ __forceinline__ u64 make_key(float d2, int flat) {
  return (static_cast<u64>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned>(flat);
}

// Keys a query's pool holds (even): its k best so far and room for new
// keys, k / 2 and at least kNew and a tile's.
__host__ __device__ inline int pool_keys(int k, int tile) {
  int room = k / 2 > kNew ? k / 2 : kNew;
  room = room > tile ? room : tile;
  return (k + room + 1) & ~1;
}

__host__ __device__ inline long long align16(long long b) { return (b + 15) & ~15LL; }

// The scoring block's dynamic shared memory: the pools, one list merged
// at a time, the queries, the row ring with its norms, a 256-bin histogram
// per warp, and the list of kept slots.
__host__ __device__ inline long long part_smem(int n, int k, int group, int tile,
                                               int stages) {
  const long long n_pad = (n + 3) & ~3;
  return align16(8LL * group * pool_keys(k, tile) + 16LL * k) + 4LL * group * n_pad +
         4LL * stages * tile * (n_pad + 1) + 1024LL * kWarps + 12LL * kEv;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// One level of the transposed butterfly: of 2h values, the lane keeps the
// h of the pairs whose bit `off` is its own, added to its partner's (lane
// ^ off) values of the same pairs, own value first, as warp_sum adds.
template <int H>
__device__ __forceinline__ void fold(float* a, int lane, int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? a[i] : a[i + H];
    const float keep = upper ? a[i + H] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// a[i], i < 32, are this lane's partials of pair i; returns pair `lane`'s
// sum, bit for bit climber::warp_sum of that pair's partials.
__device__ __forceinline__ float transpose_sum(float* a, int lane) {
  fold<16>(a, lane, 16);
  fold<8>(a, lane, 8);
  fold<4>(a, lane, 4);
  fold<2>(a, lane, 2);
  fold<1>(a, lane, 1);
  return a[0];
}

// ---- the plan's inversion -----------------------------------------------

__device__ __forceinline__ int first_live(const int* row, int mp) {
  int lo = 0, hi = mp;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A warp per plan row: its segments counted into their partitions.
__global__ void refine_count_kernel(const int* __restrict__ sel_part,
                                    unsigned* __restrict__ pcount,
                                    unsigned* __restrict__ qsegs,
                                    u64* __restrict__ ctr, int qn, int mp) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= qn) return;
  const int* row = sel_part + static_cast<long long>(q) * mp;
  const int first = first_live(row, mp);
  unsigned segs = 0;
  for (int b = first; b < mp; b += 32) {
    const int s = b + lane;
    bool start = false;
    if (s < mp) {
      const int p = row[s];
      start = s == first || row[s - 1] != p;
      if (start) atomicAdd(pcount + p, 1u);
    }
    segs += __popc(__ballot_sync(0xffffffffu, start));
  }
  if (lane == 0) {
    qsegs[q] = segs;
    atomicAdd(ctr + kCtrPairs, static_cast<u64>(segs));
  }
}

// One block: pstart = exclusive scan of pcount; items = each partition's
// segments split evenly into ceil(count / group) runs {first, count}.
__global__ void refine_scan_kernel(const unsigned* __restrict__ pcount,
                                   unsigned* __restrict__ pstart,
                                   int2* __restrict__ items,
                                   u64* __restrict__ ctr, int np, int group) {
  __shared__ unsigned s_seg[1024], s_item[1024];
  __shared__ unsigned s_carry_seg, s_carry_item, s_parts;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_carry_seg = 0;
    s_carry_item = 0;
    s_parts = 0;
  }
  __syncthreads();
  for (int base = 0; base < np; base += blockDim.x) {
    const int p = base + tid;
    const unsigned c = p < np ? pcount[p] : 0u;
    const unsigned it = (c + group - 1) / group;
    s_seg[tid] = c;
    s_item[tid] = it;
    for (int off = 1; off < static_cast<int>(blockDim.x); off <<= 1) {
      __syncthreads();
      const unsigned a = tid >= off ? s_seg[tid - off] : 0u;
      const unsigned b = tid >= off ? s_item[tid - off] : 0u;
      __syncthreads();
      s_seg[tid] += a;
      s_item[tid] += b;
    }
    __syncthreads();
    const unsigned seg0 = s_carry_seg + s_seg[tid] - c;
    const unsigned item0 = s_carry_item + s_item[tid] - it;
    if (p < np) {
      pstart[p] = seg0;
      for (unsigned i = 0; i < it; ++i) {
        const unsigned lo = seg0 + static_cast<unsigned>(
            static_cast<u64>(i) * c / it);
        const unsigned hi = seg0 + static_cast<unsigned>(
            static_cast<u64>(i + 1) * c / it);
        items[item0 + i] = make_int2(static_cast<int>(lo), static_cast<int>(hi - lo));
      }
      if (c > 0) atomicAdd(&s_parts, 1u);
    }
    __syncthreads();
    if (tid == static_cast<int>(blockDim.x) - 1) {
      s_carry_seg += s_seg[tid];
      s_carry_item += s_item[tid];
    }
    __syncthreads();
  }
  if (tid == 0) {
    ctr[kCtrItems] = s_carry_item;
    ctr[kCtrParts] = s_parts;
  }
}

// A warp per plan row: each segment into its partition's bucket, as
// {q * mp + first entry, ordinal of the segment in its row}.
__global__ void refine_scatter_kernel(const int* __restrict__ sel_part,
                                      const unsigned* __restrict__ pstart,
                                      unsigned* __restrict__ pcur,
                                      int2* __restrict__ seg, int qn, int mp) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= qn) return;
  const int* row = sel_part + static_cast<long long>(q) * mp;
  const int first = first_live(row, mp);
  int ordinal = 0;
  for (int b = first; b < mp; b += 32) {
    const int s = b + lane;
    bool start = false;
    int p = 0;
    if (s < mp) {
      p = row[s];
      start = s == first || row[s - 1] != p;
    }
    const unsigned m = __ballot_sync(0xffffffffu, start);
    if (start) {
      const unsigned pos = pstart[p] + atomicAdd(pcur + p, 1u);
      seg[pos] = make_int2(q * mp + s, ordinal + __popc(m & ((1u << lane) - 1u)));
    }
    ordinal += __popc(m);
  }
}

// ---- the partition-major scoring ----------------------------------------

// The k-th smallest of the distinct keys a[0, n), 1 <= k <= n.  One warp:
// 8-bit radix digits from the top, each bucket counted in the warp's own
// histogram, until the k-th key's bucket holds it alone.
__device__ u64 select_warp(const u64* a, int n, int k, unsigned* hist, int lane) {
  // the bytes every key shares are skipped
  u64 all = kEmpty, any = 0;
  for (int i = lane; i < n; i += 32) {
    all &= a[i];
    any |= a[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    all &= __shfl_xor_sync(0xffffffffu, all, off);
    any |= __shfl_xor_sync(0xffffffffu, any, off);
  }
  int shift = 56;
  u64 pmask = 0;
  while (shift > 0 && ((all ^ any) >> shift) == 0) {
    pmask |= 0xFFull << shift;
    shift -= 8;
  }
  u64 prefix = all & pmask;
  unsigned want = static_cast<unsigned>(k);  // its rank among keys under prefix
  for (;; shift -= 8) {
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const u64 x = i < n ? a[i] : 0;
      const bool in = i < n && (x & pmask) == prefix;
      const unsigned bin = in ? static_cast<unsigned>((x >> shift) & 0xFFu) : 256u;
      const unsigned same = __match_any_sync(0xffffffffu, bin);
      if (in && lane == __ffs(same) - 1) atomicAdd(hist + bin, __popc(same));
    }
    __syncwarp();
    unsigned c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = hist[8 * lane + j];
      sum += c[j];
    }
    unsigned inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += t;
    }
    const unsigned exc = inc - sum;
    const int src = __ffs(__ballot_sync(0xffffffffu, exc < want && want <= inc)) - 1;
    unsigned digit = 0, before = 0, count = 0;
    if (lane == src) {
      unsigned acc = exc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (count == 0 && acc + c[j] >= want) {
          digit = 8 * lane + j;
          before = acc;
          count = c[j];
        }
        acc += c[j];
      }
    }
    digit = __shfl_sync(0xffffffffu, digit, src);
    before = __shfl_sync(0xffffffffu, before, src);
    count = __shfl_sync(0xffffffffu, count, src);
    want -= before;
    prefix |= static_cast<u64>(digit) << shift;
    pmask |= 0xFFull << shift;
    __syncwarp();
    if (count == 1 || shift == 0) break;
  }
  if (pmask == kEmpty) return prefix;
  bool has = false;
  u64 found = 0;
  for (int i = lane; i < n; i += 32) {
    const u64 x = a[i];
    if ((x & pmask) == prefix) {
      has = true;
      found = x;
    }
  }
  return __shfl_sync(0xffffffffu, found, __ffs(__ballot_sync(0xffffffffu, has)) - 1);
}

// Keep the keys of a[0, n) at or below kth, in place, in order; returns
// their count.  One warp.
__device__ int keep_warp(u64* a, int n, u64 kth, int lane) {
  const unsigned lt_mask = (1u << lane) - 1u;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const u64 x = i < n ? a[i] : kEmpty;
    const bool keep = i < n && x <= kth;
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    if (keep) a[base + __popc(b & lt_mask)] = x;
    base += __popc(b);
    __syncwarp();
  }
  return base;
}

// NV float4 per lane per row in unrolled loops (n <= 128 NV), the unit's
// queries held in registers; or NV = 0: runtime loops, float4 where vec4 is
// set, scalar otherwise.
template <int NV>
__global__ void __launch_bounds__(kThreads, 1) refine_part_kernel(
    const float* __restrict__ data, const float* __restrict__ norms,
    const int* __restrict__ rec_dfs, const int* __restrict__ rec_gid,
    const float* __restrict__ queries, const int* __restrict__ sel_part,
    const int* __restrict__ sel_lo, const int* __restrict__ sel_hi,
    const int2* __restrict__ seg, const int2* __restrict__ items,
    u64* __restrict__ ctr, u64* __restrict__ lists, u64* __restrict__ bound,
    unsigned* __restrict__ locks, int mp, int cap, int n, int k, int nlists,
    int tile, int stages, int vec4) {
  constexpr int NR = NV > 0 ? NV : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_pad = (n + 3) & ~3;
  const int n4 = n / 4;
  const int pk = pool_keys(k, tile);

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u64 s_thresh[kMaxGroup];
  __shared__ int s_cnt[kMaxGroup];
  __shared__ float s_q2[kMaxGroup];
  __shared__ int s_q[kMaxGroup], s_e0[kMaxGroup], s_ne[kMaxGroup], s_list[kMaxGroup];
  __shared__ int s_lo[kMaxGroup][kEnt], s_hi[kMaxGroup][kEnt];
  __shared__ int2 s_key[kMaxGroup];
  __shared__ int s_item, s_nev, s_part, s_stage;

  const long long n_items = static_cast<long long>(ctr[kCtrItems]);
  const unsigned lt_mask = (1u << lane) - 1u;
  if (tid == 0) s_stage = 0;

  for (;;) {
    if (tid == 0) s_item = static_cast<int>(atomicAdd(ctr + kCtrNext, 1ull));
    __syncthreads();
    const int item = s_item;
    if (item >= n_items) break;
    const int2 it = items[item];
    const int nq = it.y;
    // this item's layout: nq pools, the merge stage, nq query rows, the
    // ring and its norms, the histograms, the list
    u64* buf = reinterpret_cast<u64*>(smem);
    u64* stage = buf + static_cast<long long>(nq) * pk;
    float* qv = reinterpret_cast<float*>(smem + align16(8LL * (nq * pk + 2 * k)));
    float* ring = qv + nq * n_pad;
    float* nrm = ring + stages * tile * n_pad;
    unsigned* hist = reinterpret_cast<unsigned*>(nrm + stages * tile) + 256 * warp;
    int* ev_c = reinterpret_cast<int*>(nrm + stages * tile) + 256 * kWarps;
    unsigned* ev_m = reinterpret_cast<unsigned*>(ev_c + kEv);
    int* ev_d = reinterpret_cast<int*>(ev_m + kEv);

    // the item's queries in the order of their first interval, so that
    // queries that keep the same rows share a unit's block of kGw
    int2 sg = make_int2(0, 0);
    if (tid < nq) {
      sg = seg[it.x + tid];
      s_key[tid] = make_int2(sel_lo[sg.x], sel_hi[sg.x]);
    }
    __syncthreads();
    if (tid < nq) {
      const int2 mine = s_key[tid];
      int g = 0;
      for (int j = 0; j < nq; ++j) {
        const int2 o = s_key[j];
        g += o.x < mine.x || (o.x == mine.x && (o.y < mine.y || (o.y == mine.y && j < tid)));
      }
      const int q = sg.x / mp, s0 = sg.x - q * mp;
      const int* row = sel_part + static_cast<long long>(q) * mp;
      const int p = row[s0];
      int s1 = s0 + 1;
      while (s1 < mp && row[s1] == p) ++s1;
      s_q[g] = q;
      s_e0[g] = s0;
      s_ne[g] = s1 - s0;
      s_list[g] = sg.y % nlists;
      for (int e = 0; e < kEnt && s0 + e < s1; ++e) {
        s_lo[g][e] = sel_lo[sg.x + e];
        s_hi[g][e] = sel_hi[sg.x + e];
      }
      s_cnt[g] = 0;
      s_thresh[g] = __ldcg(bound + q);
      if (tid == 0) s_part = p;
    }
    __syncthreads();
    for (int g = warp; g < nq; g += kWarps) {
      const float* src = queries + static_cast<long long>(s_q[g]) * n;
      for (int j = lane; j < n_pad; j += 32) qv[g * n_pad + j] = j < n ? src[j] : 0.f;
    }
    __syncthreads();
    // |q|^2 as the query-major designs summed it: lane l takes elements
    // l, l + 32, ... with fmaf, then warp_sum
    for (int g = warp; g < nq; g += kWarps) {
      float acc = 0.f;
      for (int i = lane; i < n; i += 32) acc = fmaf(qv[g * n_pad + i], qv[g * n_pad + i], acc);
      acc = climber::warp_sum(acc);
      if (lane == 0) s_q2[g] = acc;
    }
    // a warp scores one block of kGw queries in every tile: with NV, its
    // float4 of those queries stay in registers for the whole item
    // (kWarps / nqb warps a block; the rest idle while rows are scored)
    const int nqb = (nq + kGw - 1) / kGw;
    const int per_qb = kWarps / nqb;
    const int gb = warp / per_qb;
    const int g0 = gb * kGw;
    float4 qr[kGw][NR];
    if (NV > 0) {
#pragma unroll
      for (int g = 0; g < kGw; ++g)
#pragma unroll
        for (int v = 0; v < NR; ++v) {
          const int j = lane + 32 * v;
          qr[g][v] = (g0 + g < nq && j < n4)
                         ? reinterpret_cast<const float4*>(qv + (g0 + g) * n_pad)[j]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    const long long pbase = static_cast<long long>(s_part) * cap;

    // the first covering entry of query g's segment for tag dfs, or -1
    auto cover = [&](int g, int dfs) -> int {
      const int ne = s_ne[g];
      for (int e = 0; e < ne; ++e) {
        int lo, hi;
        if (e < kEnt) {
          lo = s_lo[g][e];
          hi = s_hi[g][e];
        } else {
          const long long at = static_cast<long long>(s_q[g]) * mp + s_e0[g] + e;
          lo = __ldg(sel_lo + at);
          hi = __ldg(sel_hi + at);
        }
        if (dfs >= lo && dfs < hi) return s_e0[g] + e;
      }
      return -1;
    };

    for (int c0 = 0; c0 < cap;) {
      // ---- tags: the slots some query of the item keeps, listed with the
      // queries that keep them, kScan slots a pass --------------------------
      if (tid == 0) s_nev = 0;
      __syncthreads();
      int nev = 0;
      while (c0 < cap && nev <= kEv - kScan) {
        int gid[kScanPer], dfs[kScanPer];
#pragma unroll
        for (int u = 0; u < kScanPer; ++u) {
          const int c = c0 + u * kThreads + tid;
          gid[u] = -1;
          dfs[u] = 0;
          if (c < cap) {
            gid[u] = __ldg(rec_gid + pbase + c);
            dfs[u] = __ldg(rec_dfs + pbase + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kScanPer; ++u) {
          unsigned m = 0;
          if (gid[u] >= 0)
            for (int g = 0; g < nq; ++g)
              if (cover(g, dfs[u]) >= 0) m |= 1u << g;
          const unsigned b = __ballot_sync(0xffffffffu, m != 0);
          int pos = 0;
          if (lane == 0 && b) pos = atomicAdd(&s_nev, __popc(b));
          pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(b & lt_mask);
          if (m) {
            ev_c[pos] = c0 + u * kThreads + tid;
            ev_m[pos] = m;
            ev_d[pos] = dfs[u];
          }
        }
        c0 += kScan;
        __syncthreads();
        nev = s_nev;                     // read by all before the next pass adds
        __syncthreads();
      }

      // ---- rows: the listed rows into a ring of `stages` tiles of `tile`
      // rows with cp.async, each scored for every query that keeps it ------
      const int nt = (nev + tile - 1) / tile;
      auto issue = [&](int t) {
        if (t < nt) {
          const int st = t % stages;
          const int e0 = t * tile;
          const int nr = nev - e0 < tile ? nev - e0 : tile;
          for (int r = warp; r < nr; r += kWarps) {
            const long long slot = pbase + ev_c[e0 + r];
            const float* src = data + slot * n;
            float* dst = ring + (st * tile + r) * n_pad;
            if (vec4) {
              for (int j = lane; j < n4; j += 32) cp_async16(dst + 4 * j, src + 4 * j);
            } else {
              for (int j = lane; j < n; j += 32) cp_async4(dst + j, src + j);
            }
            if (lane == 0) cp_async4(nrm + st * tile + r, norms + slot);
          }
        }
        cp_async_commit();
      };
      for (int t = 0; t < stages - 1; ++t) issue(t);
      for (int t = 0; t < nt; ++t) {
        issue(t + stages - 1);
        cp_async_wait(stages - 1);
        __syncthreads();
        // room for a tile's keys in every pool, or cut every pool that
        // holds more to its k best (each warp its own queries), so that
        // the pools rarely stop the block
        bool full = false;
        for (int g = 0; g < nq; ++g) full |= s_cnt[g] > pk - tile;
        if (full) {
          for (int g = warp; g < nq; g += kWarps) {
            const int cnt = s_cnt[g];
            if (cnt > k) {
              u64* a = buf + g * pk;
              const u64 kth = select_warp(a, cnt, k, hist, lane);
              keep_warp(a, cnt, kth, lane);
              if (lane == 0) {
                s_cnt[g] = k;
                s_thresh[g] = kth < s_thresh[g] ? kth : s_thresh[g];
                atomicMin(bound + s_q[g], kth);
              }
            }
          }
          __syncthreads();
        }
        const int st = t % stages;
        const int e0 = t * tile;
        const int nr = nev - e0 < tile ? nev - e0 : tile;
        const float* rows = ring + st * tile * n_pad;
        // the queries' bounds as other blocks have lowered them, read while
        // this tile is scored
        const u64 fresh = tid < nq ? __ldcg(bound + s_q[tid]) : kEmpty;
        const int nrb = (nr + kRw - 1) / kRw;
        for (int rb = gb < nqb ? warp % per_qb : nrb; rb < nrb; rb += per_qb) {
          const int r0 = rb * kRw;
          unsigned um = 0;
          if (lane < kRw && r0 + lane < nr) um = (ev_m[e0 + r0 + lane] >> g0) & ((1u << kGw) - 1u);
          if (!__reduce_or_sync(0xffffffffu, um)) continue;
          float acc[kRw * kGw];
#pragma unroll
          for (int i = 0; i < kRw * kGw; ++i) acc[i] = 0.f;
          const float* xr = rows + r0 * n_pad;
          const float* qb = qv + g0 * n_pad;
          // each pair's four fmaf per float4 in the order of the
          // query-major designs
          if (NV > 0) {
#pragma unroll
            for (int v = 0; v < NR; ++v) {
              const int j = lane + 32 * v;
              if (j < n4) {
                float4 x[kRw];
#pragma unroll
                for (int r = 0; r < kRw; ++r)
                  x[r] = reinterpret_cast<const float4*>(xr + r * n_pad)[j];
#pragma unroll
                for (int g = 0; g < kGw; ++g)
#pragma unroll
                  for (int r = 0; r < kRw; ++r) {
                    float& a = acc[r * kGw + g];
                    a = fmaf(x[r].x, qr[g][v].x, a);
                    a = fmaf(x[r].y, qr[g][v].y, a);
                    a = fmaf(x[r].z, qr[g][v].z, a);
                    a = fmaf(x[r].w, qr[g][v].w, a);
                  }
              }
            }
          } else if (vec4) {
            for (int j = lane; j < n4; j += 32) {
              float4 x[kRw];
#pragma unroll
              for (int r = 0; r < kRw; ++r)
                x[r] = reinterpret_cast<const float4*>(xr + r * n_pad)[j];
#pragma unroll
              for (int g = 0; g < kGw; ++g) {
                const float4 qq = reinterpret_cast<const float4*>(qb + g * n_pad)[j];
#pragma unroll
                for (int r = 0; r < kRw; ++r) {
                  float& a = acc[r * kGw + g];
                  a = fmaf(x[r].x, qq.x, a);
                  a = fmaf(x[r].y, qq.y, a);
                  a = fmaf(x[r].z, qq.z, a);
                  a = fmaf(x[r].w, qq.w, a);
                }
              }
            }
          } else {
            for (int j = lane; j < n; j += 32) {
              float x[kRw];
#pragma unroll
              for (int r = 0; r < kRw; ++r) x[r] = xr[r * n_pad + j];
#pragma unroll
              for (int g = 0; g < kGw; ++g) {
                const float qq = qb[g * n_pad + j];
#pragma unroll
                for (int r = 0; r < kRw; ++r)
                  acc[r * kGw + g] = fmaf(x[r], qq, acc[r * kGw + g]);
              }
            }
          }
          const float dot = transpose_sum(acc, lane);
          // lane l owns pair l: row r0 + l / kGw, query g0 + l % kGw
          const int r = r0 + lane / kGw;
          const int g = g0 + lane % kGw;
          if (r < nr && g < nq && ((ev_m[e0 + r] >> g) & 1u)) {
            const int s = cover(g, ev_d[e0 + r]);
            float d2 = __fadd_rn(__fsub_rn(s_q2[g], __fmul_rn(2.f, dot)), nrm[st * tile + r]);
            d2 = d2 > 0.f ? d2 : 0.f;
            const u64 key = make_key(d2, s * cap + ev_c[e0 + r]);
            if (key < s_thresh[g]) {
              const int pos = atomicAdd(&s_cnt[g], 1);
              buf[g * pk + pos] = key;
            }
          }
        }
        __syncthreads();
        if (tid < nq && fresh < s_thresh[tid]) s_thresh[tid] = fresh;
      }
      cp_async_wait(0);
    }

    // ---- the item's k-best of each query, sorted, into one of its lists:
    // each warp its own queries, a list another segment of the query wrote
    // first merged with it under the list's lock ---------------------------
    for (int g = warp; g < nq; g += kWarps) {
      u64* a = buf + g * pk;
      int m = s_cnt[g];
      if (m >= k) {
        u64 kth = 0;
        if (m > k) {
          kth = select_warp(a, m, k, hist, lane);
          keep_warp(a, m, kth, lane);
          m = k;
        } else {
          for (int i = lane; i < k; i += 32) kth = a[i] > kth ? a[i] : kth;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const u64 o = __shfl_xor_sync(0xffffffffu, kth, off);
            kth = o > kth ? o : kth;
          }
        }
        if (lane == 0) atomicMin(bound + s_q[g], kth);
      }
      u64* dst = lists + (static_cast<long long>(s_q[g]) * nlists + s_list[g]) * k;
      unsigned* lock = locks + static_cast<long long>(s_q[g]) * nlists + s_list[g];
      unsigned prev = 0;
      if (lane == 0) {
        for (;;) {
          prev = atomicOr(lock, kLocked);
          if (!(prev & kLocked)) break;
          __nanosleep(100);
        }
      }
      prev = __shfl_sync(0xffffffffu, prev, 0);
      __threadfence();
      if (prev == 0) {
        for (int i = lane; i < k; i += 32) __stcg(dst + i, i < m ? a[i] : kEmpty);
      } else {
        // another segment of the query wrote this list first: the k best of
        // both, through the block's one stage
        if (lane == 0)
          while (atomicCAS(&s_stage, 0, 1) != 0) __nanosleep(50);
        __syncwarp();
        for (int i = lane; i < m; i += 32) stage[i] = a[i];
        int total = m;
        for (int i0 = 0; i0 < k; i0 += 32) {
          const u64 x = i0 + lane < k ? __ldcg(dst + i0 + lane) : kEmpty;
          const unsigned b = __ballot_sync(0xffffffffu, x != kEmpty);
          if (x != kEmpty) stage[total + __popc(b & lt_mask)] = x;
          total += __popc(b);
        }
        __syncwarp();
        if (total > k) {
          keep_warp(stage, total, select_warp(stage, total, k, hist, lane), lane);
          total = k;
        }
        for (int i = lane; i < k; i += 32) __stcg(dst + i, i < total ? stage[i] : kEmpty);
        __syncwarp();
        if (lane == 0) atomicExch(&s_stage, 0);
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicExch(lock, prev + 1);
    }
    __syncthreads();
  }
}

// The k best of a query's lists, sorted, as (d2, gid); one block of
// kMergeThreads a query.  Its lists' keys (unsorted, empty-padded) are
// gathered, cut to the k-th by radix digits as select_warp does, and
// bitonic-sorted.
__global__ void refine_merge_kernel(const u64* __restrict__ lists,
                                    const unsigned* __restrict__ qsegs,
                                    const int* __restrict__ sel_part,
                                    const int* __restrict__ rec_gid,
                                    float* __restrict__ out_d2,
                                    int* __restrict__ out_gid, int nlists,
                                    int mp, int cap, int k) {
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int segs = static_cast<int>(qsegs[q]);
  const int count = segs < nlists ? segs : nlists;
  extern __shared__ __align__(16) unsigned char smem[];
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  const long long keys_at = static_cast<long long>(nlists) * k;
  u64* a = reinterpret_cast<u64*>(smem);                 // the lists' keys
  u64* b = a + (keys_at > p2 ? keys_at : p2);            // the k kept
  __shared__ unsigned hist[256];
  __shared__ unsigned s_n, s_digit, s_before, s_count;
  __shared__ u64 s_kth;
  if (tid == 0) s_n = 0;
  __syncthreads();
  const u64* src = lists + static_cast<long long>(q) * nlists * k;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int i0 = 0; i0 < count * k; i0 += kMergeThreads) {
    const int i = i0 + tid;
    const u64 x = i < count * k ? src[i] : kEmpty;
    const unsigned m = __ballot_sync(0xffffffffu, x != kEmpty);
    unsigned pos = 0;
    if (lane == 0 && m) pos = atomicAdd(&s_n, __popc(m));
    pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(m & lt_mask);
    if (x != kEmpty) a[pos] = x;
  }
  __syncthreads();
  const int n = static_cast<int>(s_n);
  const u64* keys = a;
  int m = n;
  if (n > k) {
    // the k-th key: 8-bit digits from the top
    u64 prefix = 0, pmask = 0;
    unsigned want = static_cast<unsigned>(k);
    for (int shift = 56;; shift -= 8) {
      for (int i = tid; i < 256; i += kMergeThreads) hist[i] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += kMergeThreads) {
        const int i = i0 + tid;
        const u64 x = i < n ? a[i] : 0;
        const bool in = i < n && (x & pmask) == prefix;
        const unsigned bin = in ? static_cast<unsigned>((x >> shift) & 0xFFu) : 256u;
        const unsigned same = __match_any_sync(0xffffffffu, bin);
        if (in && lane == __ffs(same) - 1) atomicAdd(hist + bin, __popc(same));
      }
      __syncthreads();
      if (tid < 32) {
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = hist[8 * lane + j];
          sum += c[j];
        }
        unsigned inc = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned t = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += t;
        }
        const unsigned exc = inc - sum;
        if (exc < want && want <= inc) {
          unsigned acc = exc;
          bool done = false;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!done && acc + c[j] >= want) {
              s_digit = 8 * lane + j;
              s_before = acc;
              s_count = c[j];
              done = true;
            }
            acc += c[j];
          }
        }
      }
      __syncthreads();
      want -= s_before;
      prefix |= static_cast<u64>(s_digit) << shift;
      pmask |= 0xFFull << shift;
      const bool stop = s_count == 1 || shift == 0;
      __syncthreads();
      if (stop) break;
    }
    if (pmask == kEmpty) {
      if (tid == 0) s_kth = prefix;
    } else {
      for (int i = tid; i < n; i += kMergeThreads)
        if ((a[i] & pmask) == prefix) s_kth = a[i];
    }
    if (tid == 0) s_n = 0;
    __syncthreads();
    const u64 kth = s_kth;
    for (int i0 = 0; i0 < n; i0 += kMergeThreads) {
      const int i = i0 + tid;
      const bool keep = i < n && a[i] <= kth;
      const unsigned bm = __ballot_sync(0xffffffffu, keep);
      unsigned pos = 0;
      if (lane == 0 && bm) pos = atomicAdd(&s_n, __popc(bm));
      pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(bm & lt_mask);
      if (keep) b[pos] = a[i];
    }
    keys = b;
    m = k;
  }
  // bitonic sort of the m kept keys, padded to a power of two
  u64* sorted = const_cast<u64*>(keys);
  int ls = 1;
  while (ls < m) ls <<= 1;
  __syncthreads();
  for (int i = m + tid; i < ls; i += kMergeThreads) sorted[i] = kEmpty;
  for (int size = 2; size <= ls; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < (ls >> 1); i += kMergeThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 x = sorted[lo];
        const u64 y = sorted[hi];
        if ((x > y) == up) {
          sorted[lo] = y;
          sorted[hi] = x;
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < k; i += kMergeThreads) {
    const u64 key = i < m ? sorted[i] : kEmpty;
    float d2 = kPadDist;
    int gid = -1;
    if (key != kEmpty) {
      const int f = static_cast<int>(key & 0xFFFFFFFFull);
      const int s = f / cap;
      d2 = __uint_as_float(static_cast<unsigned>(key >> 32));
      gid = rec_gid[static_cast<long long>(sel_part[q * mp + s]) * cap +
                    (f - s * cap)];
    }
    out_d2[static_cast<long long>(q) * k + i] = d2;
    out_gid[static_cast<long long>(q) * k + i] = gid;
  }
}

// The scoring kernel for row width n: two float4 per lane per row up to
// n = 256 (the configuration's width), runtime loops past it.
const void* part_kernel_for(int n, bool vec4) {
  if (vec4 && n <= 256) return reinterpret_cast<const void*>(refine_part_kernel<2>);
  return reinterpret_cast<const void*>(refine_part_kernel<0>);
}

// The scoring block's shape for (n, k): the first of the ring shapes
// (rows a tile, tiles) beside which 16 queries fit, with as many queries as
// fit; else the first beside which one fits.  False when none does.
constexpr int kShapes[][2] = {{32, 2}, {16, 3}, {32, 3}, {16, 2}, {8, 2}, {4, 2}};

// A warp's unit reads kRw ring rows from a multiple of kRw: a tile of fewer
// rows, or not a multiple of kRw, would let the last tile's unit read past
// the ring and the block's shared memory (a variant with 8-row units faulted
// so at n = 2,048, where the ring is 4 rows a tile).
constexpr bool tiles_hold_units() {
  for (const auto& sh : kShapes)
    if (sh[0] % kRw != 0) return false;
  return true;
}
static_assert(tiles_hold_units(), "every ring tile holds whole units of kRw rows");

bool part_shape(int n, int k, int* group, int* tile, int* stages) {
  const long long limit = 232448 - kStatic;
  for (int want = 16; want >= 1; want -= 15) {
    for (const auto& sh : kShapes) {
      int g = kMaxGroup;
      while (g >= want && part_smem(n, k, g, sh[0], sh[1]) > limit) --g;
      if (g >= want) {
        *group = g;
        *tile = sh[0];
        *stages = sh[1];
        return true;
      }
    }
  }
  return false;
}

long long merge_dyn_smem(int nlists, int k) {
  long long p2 = 1;
  while (p2 < k) p2 <<= 1;
  const long long keys = static_cast<long long>(nlists) * k;
  return 8LL * ((keys > p2 ? keys : p2) + p2);
}

struct Layout {
  long long lists, seg, items, bound, qsegs, pstart, ctr, locks, pcount, pcur, total,
      zero_from;
};

Layout layout(int q, int mp, int p, int k, int nlists, int group) {
  Layout l;
  long long at = 0;
  l.lists = at;  at += align16(8LL * q * nlists * k);
  l.seg = at;    at += align16(8LL * q * mp);
  l.items = at;  at += align16(8LL * (p + (static_cast<long long>(q) * mp + group - 1) / group));
  l.bound = at;  at += align16(8LL * q);
  l.qsegs = at;  at += align16(4LL * q);
  l.pstart = at; at += align16(4LL * p);
  l.zero_from = at;
  l.ctr = at;    at += 8LL * kCtrWords;
  l.locks = at;  at += align16(4LL * q * nlists);
  l.pcount = at; at += align16(4LL * p);
  l.pcur = at;   at += align16(4LL * p);
  l.total = at;
  return l;
}

// ---- the query-major design (climber_refine_topk_query_major) -----------
namespace qm {

constexpr int kRun = 8;                   // merge outputs per thread task
constexpr int kScanPer = 8;               // tag pairs in flight per thread
constexpr int kScan = kThreads * kScanPer;   // slots per tag pass
constexpr int kEv = 4096;                 // kept flat indices held at once
constexpr int kBuf = 4096;                // candidate keys before a merge
constexpr long long kMinChunk = 2048;     // fewest live slots per block
constexpr int kWaves = 4;                 // blocks per batch, in resident grids

// Ascending bitonic sort of keys[0, L), L a power of two; whole block.
__device__ void bitonic_sort(u64* keys, int L) {
  for (int size = 2; size <= L; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < L / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = keys[lo];
        const u64 b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

// Element p of the ascending merge of a[0, la) and b[0, lb) (merge path;
// equal keys take a first).
__device__ __forceinline__ u64 merge_at(const u64* a, int la, const u64* b,
                                        int lb, int p) {
  int lo = p > lb ? p - lb : 0;
  int hi = p < la ? p : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[p - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  const int j = p - lo;
  return (j >= lb || (lo < la && a[lo] <= b[j])) ? a[lo] : b[j];
}

// Per query: meta[q] = pad entries | blocks << 32, and meta[qn + q] = 0,
// the counter its blocks take chunks from.
__global__ void refine_plan_kernel(const int* __restrict__ sel_part,
                                   u64* __restrict__ meta, int qn, int mp,
                                   int cap, int splits, long long target) {
  __shared__ unsigned long long s_total;
  if (threadIdx.x == 0) s_total = 0;
  __syncthreads();
  for (int q = threadIdx.x; q < qn; q += blockDim.x) {
    const int* row = sel_part + static_cast<long long>(q) * mp;
    int lo = 0, hi = mp;                   // first live entry
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < 0) lo = mid + 1; else hi = mid;
    }
    meta[q] = static_cast<unsigned>(lo);
    meta[qn + q] = 0;                      // the query's chunk counter
    atomicAdd(&s_total, static_cast<unsigned long long>(mp - lo) * cap);
  }
  __syncthreads();
  // rounding each query's count up adds at most one block per query: keep
  // the batch within one wave of `target` blocks where it can
  const long long room = target - qn > target / 2 ? target - qn : target / 2;
  long long chunk = climber::ceil_div(static_cast<long long>(s_total), room);
  chunk = chunk > kMinChunk ? chunk : kMinChunk;
  for (int q = threadIdx.x; q < qn; q += blockDim.x) {
    const long long live = static_cast<long long>(mp - static_cast<int>(meta[q])) * cap;
    long long s = climber::ceil_div(live, chunk);
    s = s < 1 ? 1 : (s > splits ? splits : s);
    meta[q] |= static_cast<u64>(s) << 32;
  }
}

// Merge buf[0, nb) into the sorted best-list top[0, ntop) (capacity k);
// returns the new length.  Whole block; keys are distinct.
__device__ int merge_buffer(u64*& top, u64*& top2, u64* buf, int nb, int ntop,
                            int k) {
  int L = 1;
  while (L < nb) L <<= 1;
  for (int i = nb + threadIdx.x; i < L; i += kThreads) buf[i] = kEmpty;
  bitonic_sort(buf, L);
  const int len = ntop + nb < k ? ntop + nb : k;
  for (int p = threadIdx.x; p < len; p += kThreads)
    top2[p] = merge_at(top, ntop, buf, nb, p);
  __syncthreads();
  u64* t = top;
  top = top2;
  top2 = t;
  return len;
}

// R rows of NV float4 per lane each, per warp in flight (NV = 0: any n,
// runtime loops).
template <int NV>
__global__ void __launch_bounds__(kThreads, 2) refine_partial_kernel(
    const float* __restrict__ data, const float* __restrict__ norms,
    const int* __restrict__ rec_dfs, const int* __restrict__ rec_gid,
    const float* __restrict__ queries, const int* __restrict__ sel_part,
    const int* __restrict__ sel_lo, const int* __restrict__ sel_hi,
    u64* __restrict__ partial, const u64* __restrict__ meta,
    unsigned long long* __restrict__ work, int mp, int cap, int n, int k,
    int vec4) {
  constexpr int R = NV == 0 ? 4 : 8;   // rows per warp in flight
  const int q = blockIdx.y;
  const int split = blockIdx.x;
  const u64 mq = meta[q];
  const int first_live = static_cast<int>(mq & 0xFFFFFFFFull);
  const int blocks = static_cast<int>(mq >> 32);
  u64* out = partial + (static_cast<long long>(q) * gridDim.x + split) * k;
  if (split >= blocks) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  u64* top = reinterpret_cast<u64*>(smem);                // [k]
  u64* top2 = top + k;                                    // [k]
  u64* buf = top2 + k;                                    // [kBuf]
  int* ev = reinterpret_cast<int*>(buf + kBuf);           // [kEv]
  const int n_pad = (n + 3) & ~3;
  float* q_s = reinterpret_cast<float*>(ev + kEv);        // [n_pad]
  // the plan row's live entries first_live.. mp - 1, at s - first_live
  int* sp_s = reinterpret_cast<int*>(q_s + n_pad);        // [mp - first_live]
  int* lo_s = sp_s + mp;
  int* hi_s = lo_s + mp;
  int* seg_s = hi_s + mp;                                 // segment start
  __shared__ int s_nev, s_nbuf, s_base;
  __shared__ u64 s_thresh;
  __shared__ float s_q2;

  const float* qrow = queries + static_cast<long long>(q) * n;
  for (int i = tid; i < n_pad; i += kThreads) q_s[i] = i < n ? qrow[i] : 0.f;
  for (int s = first_live + tid; s < mp; s += kThreads) {
    sp_s[s - first_live] = sel_part[q * mp + s];
    lo_s[s - first_live] = sel_lo[q * mp + s];
    hi_s[s - first_live] = sel_hi[q * mp + s];
  }
  if (tid == 0) {
    s_nev = 0;
    s_nbuf = 0;
    s_thresh = kEmpty;
  }
  __syncthreads();
  for (int s = first_live + tid; s < mp; s += kThreads) {
    int t = s;
    while (t > first_live && sp_s[t - 1 - first_live] == sp_s[s - first_live]) --t;
    seg_s[s - first_live] = t;
  }
  if (warp == 0) {
    float acc = 0.f;
    for (int i = lane; i < n; i += 32) acc = fmaf(q_s[i], q_s[i], acc);
    acc = climber::warp_sum(acc);
    if (lane == 0) s_q2 = acc;
  }
  __syncthreads();

  // the query's live flat range (pads sort first), taken kScan slots at a
  // time from a counter its blocks share, so they finish together however
  // many records each chunk keeps
  const int first = first_live * cap;
  const int end = mp * cap;
  const unsigned long long chunks =
      (static_cast<long long>(end) - first + kScan - 1) / kScan;
  const float q2 = s_q2;
  const int n4 = n / 4;
  const unsigned lt_mask = (1u << lane) - 1u;
  int ntop = 0;

  for (;;) {
    if (tid == 0) {
      const unsigned long long c = atomicAdd(work + q, 1ull);
      s_base = c < chunks ? first + static_cast<int>(c) * kScan : end;
    }
    __syncthreads();
    const int base = s_base;
    // ---- tags: the inclusion predicate of kScanPer slots per thread -----
    int gid[kScanPer], dfs[kScanPer];
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      const int f = base + u * kThreads + tid;
      gid[u] = -1;
      if (f < end) {
        const int s = f / cap;
        const long long slot =
            static_cast<long long>(sp_s[s - first_live]) * cap + (f - s * cap);
        gid[u] = __ldg(rec_gid + slot);
        dfs[u] = __ldg(rec_dfs + slot);
      }
    }
    bool near_full = false;
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      const int f = base + u * kThreads + tid;
      bool keep = gid[u] >= 0;
      if (keep) {
        const int s = f / cap;
        const int sl = s - first_live;
        keep = dfs[u] >= lo_s[sl] && dfs[u] < hi_s[sl];
        for (int t = seg_s[sl] - first_live; keep && t < sl; ++t)
          if (dfs[u] >= lo_s[t] && dfs[u] < hi_s[t]) keep = false;
      }
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      int pos = 0;
      if (lane == 0 && m) pos = atomicAdd(&s_nev, __popc(m));
      pos = __shfl_sync(0xffffffffu, pos, 0);
      if (keep) ev[pos + __popc(m & lt_mask)] = f;
      near_full |= lane == 0 && pos + __popc(m) > kEv - kScan;
    }
    const bool done = base >= end;
    if (!__syncthreads_or(near_full) && !done) continue;

    // ---- rows: each warp streams R kept rows at a time, with their norms;
    // no barrier until the list is done ------------------------------------
    const int nev = s_nev;
    if (s_nbuf + nev > kBuf) {         // make room for every key of this list
      ntop = merge_buffer(top, top2, buf, s_nbuf, ntop, k);
      if (tid == 0) {
        s_nbuf = 0;
        s_thresh = ntop == k ? top[k - 1] : kEmpty;
      }
      __syncthreads();
    }
    for (int e0 = warp * R; e0 < nev; e0 += kWarps * R) {
      // lane r < R owns row e0 + r: its slot, norm and, below, its key
      const bool live_row = lane < R && e0 + lane < nev;
      const int fr = ev[live_row ? e0 + lane : e0];
      long long my_slot;
      {
        const int s = fr / cap;
        my_slot = static_cast<long long>(sp_s[s - first_live]) * cap + (fr - s * cap);
      }
      const float nrm = live_row ? __ldg(norms + my_slot) : 0.f;
      long long slot[R];
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        slot[r] = __shfl_sync(0xffffffffu, my_slot, r);
        acc[r] = 0.f;
      }
      if (NV > 0) {
        float4 x[R][NV > 0 ? NV : 1];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int j = lane + 32 * v;
            x[r][v] = (e0 + r < nev && j < n4)
                          ? __ldcs(reinterpret_cast<const float4*>(data + slot[r] * n) + j)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int j = lane + 32 * v;
          if (j < n4) {
            const float4 qq = q4[j];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r] = fmaf(x[r][v].x, qq.x, acc[r]);
              acc[r] = fmaf(x[r][v].y, qq.y, acc[r]);
              acc[r] = fmaf(x[r][v].z, qq.z, acc[r]);
              acc[r] = fmaf(x[r][v].w, qq.w, acc[r]);
            }
          }
        }
      } else if (vec4) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int j = lane; j < n4; j += 32) {
          const float4 qq = q4[j];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (e0 + r >= nev) break;
            const float4 x = __ldg(reinterpret_cast<const float4*>(data + slot[r] * n) + j);
            acc[r] = fmaf(x.x, qq.x, acc[r]);
            acc[r] = fmaf(x.y, qq.y, acc[r]);
            acc[r] = fmaf(x.z, qq.z, acc[r]);
            acc[r] = fmaf(x.w, qq.w, acc[r]);
          }
        }
      } else {
        for (int j = lane; j < n; j += 32) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (e0 + r >= nev) break;
            acc[r] = fmaf(__ldg(data + slot[r] * n + j), q_s[j], acc[r]);
          }
        }
      }
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = climber::warp_sum(acc[r]);
        dot = lane == r ? v : dot;
      }
      u64 key = kEmpty;
      if (live_row) {
        float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), nrm);
        d2 = d2 > 0.f ? d2 : 0.f;
        key = make_key(d2, fr);
      }
      const bool pass = live_row && key < *static_cast<volatile u64*>(&s_thresh);
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      int pos = 0;
      if (lane == 0 && m) pos = atomicAdd(&s_nbuf, __popc(m));
      pos = __shfl_sync(0xffffffffu, pos, 0);
      if (pass) buf[pos + __popc(m & lt_mask)] = key;
    }
    __syncthreads();                   // every key is in; every thread read s_nev
    if (tid == 0) s_nev = 0;
    __syncthreads();
    if (done) break;
  }

  const int nb = s_nbuf;               // stable: the last barrier is past
  if (nb > 0) ntop = merge_buffer(top, top2, buf, nb, ntop, k);
  for (int i = tid; i < k; i += kThreads) out[i] = i < ntop ? top[i] : kEmpty;
}

__global__ void refine_merge_kernel(const u64* __restrict__ partial,
                                    const u64* __restrict__ meta,
                                    const int* __restrict__ sel_part,
                                    const int* __restrict__ rec_gid,
                                    unsigned* __restrict__ seen,
                                    u64* __restrict__ sharing,
                                    float* __restrict__ out_d2,
                                    int* __restrict__ out_gid, int splits,
                                    int mp, int cap, int k) {
  const int q = blockIdx.x;
  const int lists = static_cast<int>(meta[q] >> 32);
  // the plan's sharing, as the partition-major design counts it: the
  // query's (query, partition) segments, and a partition the first time a
  // query names it
  {
    const int* row = sel_part + static_cast<long long>(q) * mp;
    unsigned segs = 0, parts = 0;
    for (int s = threadIdx.x; s < mp; s += blockDim.x) {
      const int p = row[s];
      if (p >= 0 && (s == 0 || row[s - 1] != p)) {
        ++segs;
        parts += atomicExch(seen + p, 1u) == 0u;
      }
    }
    segs = __reduce_add_sync(0xffffffffu, segs);
    parts = __reduce_add_sync(0xffffffffu, parts);
    if ((threadIdx.x & 31) == 0 && segs) {
      atomicAdd(sharing, static_cast<u64>(segs));
      if (parts) atomicAdd(sharing + 1, static_cast<u64>(parts));
    }
  }
  extern __shared__ __align__(16) unsigned char smem[];
  u64* a = reinterpret_cast<u64*>(smem);                 // [splits * k]
  u64* b = a + static_cast<long long>(splits) * k;        // [splits * k]
  const u64* src = partial + static_cast<long long>(q) * splits * k;
  for (int i = threadIdx.x; i < lists * k; i += blockDim.x) a[i] = src[i];
  const int runs = (k + kRun - 1) / kRun;        // runs of outputs per pair
  for (int cnt = lists; cnt > 1; cnt = (cnt + 1) / 2) {
    __syncthreads();
    const int pairs = (cnt + 1) / 2;
    for (int task = threadIdx.x; task < pairs * runs; task += blockDim.x) {
      const int j = task / runs, p0 = (task - j * runs) * kRun;
      const u64* l0 = a + 2 * j * k;
      u64* o = b + j * k;
      const int len = k - p0 < kRun ? k - p0 : kRun;
      if (2 * j + 1 >= cnt) {
        for (int e = 0; e < len; ++e) o[p0 + e] = l0[p0 + e];
        continue;
      }
      // merge path to output p0, then kRun outputs in turn (ties take l0)
      const u64* l1 = l0 + k;
      int lo = 0, hi = p0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (l0[mid] <= l1[p0 - 1 - mid]) lo = mid + 1; else hi = mid;
      }
      int ia = lo, ib = p0 - lo;
      for (int e = 0; e < len; ++e) {
        const bool take0 = ib >= k || (ia < k && l0[ia] <= l1[ib]);
        o[p0 + e] = take0 ? l0[ia++] : l1[ib++];
      }
    }
    u64* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const u64 key = a[i];
    float d2 = kPadDist;
    int gid = -1;
    if (key != kEmpty) {
      const int f = static_cast<int>(key & 0xFFFFFFFFull);
      const int s = f / cap;
      d2 = __uint_as_float(static_cast<unsigned>(key >> 32));
      gid = rec_gid[static_cast<long long>(sel_part[q * mp + s]) * cap +
                    (f - s * cap)];
    }
    out_d2[static_cast<long long>(q) * k + i] = d2;
    out_gid[static_cast<long long>(q) * k + i] = gid;
  }
}

// The partial kernel for row width n: two float4 per lane per row up to
// n = 256 (the configuration's width), runtime loops past it.
void* partial_kernel_for(int n, bool vec4) {
  if (vec4 && n <= 256) return reinterpret_cast<void*>(refine_partial_kernel<2>);
  return reinterpret_cast<void*>(refine_partial_kernel<0>);
}

}  // namespace qm

}  // namespace

// The most queries a scoring block holds at row width n and k answers (0:
// the block's shared memory cannot hold one query's buffer and a tile).
CLIMBER_API int climber_refine_group(int n, int k) {
  int g = 0, t = 0, s = 0;
  return part_shape(n, k, &g, &t, &s) ? g : 0;
}

// Shared memory of the merge block for `nlists` lists of k keys (bytes):
// their keys, and the k kept, each padded for the sort, and its own.
CLIMBER_API long long climber_refine_merge_smem(int nlists, int k) {
  return merge_dyn_smem(nlists, k) + kMergeStatic;
}

// Device scratch of a call (bytes): nlists lists of k keys per query, the
// inverted plan, the items and the counters.
CLIMBER_API long long climber_refine_scratch_bytes(int q, int mp, int p, int k,
                                                   int nlists, int group) {
  return layout(q, mp, p, k, nlists, group).total;
}

// scratch: climber_refine_scratch_bytes(q, mp, p, k, nlists, group) bytes;
// stats: 2 u64 written with the live (query, partition) segments and the
// distinct planned partitions; out_d2 / out_gid: [q, k].  `group` is the
// most queries an item holds (at most climber_refine_group(n, k)).
CLIMBER_API int climber_refine_topk(
    const float* data, const float* norms, const int* rec_dfs,
    const int* rec_gid, const float* queries, const int* sel_part,
    const int* sel_lo, const int* sel_hi, void* scratch,
    unsigned long long* stats, float* out_d2, int* out_gid, int q, int mp,
    int p, int cap, int n, int k, int nlists, int group, void* stream) {
  if (q <= 0) return static_cast<int>(cudaSuccess);
  int gmax = 0, tile = 0, stages = 0;
  if (mp <= 0 || p <= 0 || cap <= 0 || n <= 0 || k <= 0 || nlists <= 0 ||
      group <= 0 || static_cast<long long>(mp) * cap >= 0x7FFFFFFFLL ||
      static_cast<long long>(q) * mp >= 0x7FFFFFFFLL ||
      !part_shape(n, k, &gmax, &tile, &stages) || group > gmax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const Layout l = layout(q, mp, p, k, nlists, group);
  u64* lists = reinterpret_cast<u64*>(base + l.lists);
  int2* seg = reinterpret_cast<int2*>(base + l.seg);
  int2* items = reinterpret_cast<int2*>(base + l.items);
  unsigned* qsegs = reinterpret_cast<unsigned*>(base + l.qsegs);
  unsigned* pstart = reinterpret_cast<unsigned*>(base + l.pstart);
  u64* ctr = reinterpret_cast<u64*>(base + l.ctr);
  u64* bound = reinterpret_cast<u64*>(base + l.bound);
  unsigned* locks = reinterpret_cast<unsigned*>(base + l.locks);
  unsigned* pcount = reinterpret_cast<unsigned*>(base + l.pcount);
  unsigned* pcur = reinterpret_cast<unsigned*>(base + l.pcur);

  cudaError_t err = cudaMemsetAsync(base + l.zero_from, 0, l.total - l.zero_from, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(bound, 0xFF, 8LL * q, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned row_blocks = static_cast<unsigned>(climber::ceil_div(q, kWarps));
  refine_count_kernel<<<row_blocks, kThreads, 0, s>>>(sel_part, pcount, qsegs, ctr, q, mp);
  refine_scan_kernel<<<1, 1024, 0, s>>>(pcount, pstart, items, ctr, p, group);
  refine_scatter_kernel<<<row_blocks, kThreads, 0, s>>>(sel_part, pstart, pcur, seg, q, mp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int vec4 = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(data) % 16 == 0);
  const void* kernel = part_kernel_for(n, vec4);
  const size_t smem1 = static_cast<size_t>(part_smem(n, k, group, tile, stages));
  err = climber::allow_smem(kernel, smem1);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = climber::persistent_blocks(kernel, kThreads, smem1, 1LL << 30, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&data, &norms, &rec_dfs, &rec_gid, &queries, &sel_part,
                  &sel_lo, &sel_hi, &seg, &items, &ctr, &lists, &bound, &locks, &mp,
                  &cap, &n, &k, &nlists, &tile, &stages,
                  const_cast<int*>(&vec4)};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads), args, smem1, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem2 = static_cast<size_t>(merge_dyn_smem(nlists, k));
  err = climber::allow_smem(refine_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  refine_merge_kernel<<<q, kMergeThreads, smem2, s>>>(
      lists, qsegs, sel_part, rec_gid, out_d2, out_gid, nlists, mp, cap, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(stats, ctr + kCtrPairs, 2 * sizeof(u64),
                                          cudaMemcpyDeviceToDevice, s));
}

// Shared memory the two kernels need for a call (bytes); the wrapper checks
// these against the card's limit before it picks the number of splits.
CLIMBER_API long long climber_refine_partial_smem(int mp, int n, int k) {
  return 8LL * (2LL * k + qm::kBuf) + 4LL * qm::kEv + 4LL * ((n + 3) & ~3) + 16LL * mp;
}

CLIMBER_API long long climber_refine_partial_merge_smem(int splits, int k) {
  return 16LL * splits * k;
}

// Device scratch of a query-major call (bytes): the partial lists, each
// query's plan summary and chunk counter, two sharing counters and a flag
// a partition.
CLIMBER_API long long climber_refine_partial_scratch_bytes(int q, int p, int k,
                                                           int splits) {
  return 8LL * (static_cast<long long>(q) * (static_cast<long long>(splits) * k + 2) + 2) +
         4LL * p;
}

// partial: climber_refine_partial_scratch_bytes(q, p, k, splits) bytes (the
// partial lists, then each query's plan summary, then its chunk counter,
// then the sharing counters and the partitions' flags); stats: 2 u64
// written as the partition-major design writes them; out_d2 / out_gid:
// [q, k].  `splits` is the most blocks a query may get.
CLIMBER_API int climber_refine_topk_query_major(
    const float* data, const float* norms, const int* rec_dfs,
    const int* rec_gid, const float* queries, const int* sel_part,
    const int* sel_lo, const int* sel_hi, unsigned long long* partial,
    unsigned long long* stats, float* out_d2, int* out_gid, int q, int mp,
    int p, int cap, int n, int k, int splits, void* stream) {
  if (q <= 0) return static_cast<int>(cudaSuccess);
  if (mp <= 0 || p <= 0 || cap <= 0 || n <= 0 || k <= 0 || splits <= 0 ||
      static_cast<long long>(mp) * cap >= 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* meta = partial + static_cast<long long>(q) * splits * k;
  u64* sharing = meta + 2LL * q;
  unsigned* seen = reinterpret_cast<unsigned*>(sharing + 2);
  const int vec4 = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(data) % 16 == 0);
  const void* kernel = qm::partial_kernel_for(n, vec4);
  const size_t smem1 = static_cast<size_t>(climber_refine_partial_smem(mp, n, k));
  cudaError_t err = cudaMemsetAsync(sharing, 0, 16 + 4LL * p, s);
  if (err == cudaSuccess) err = climber::allow_smem(kernel, smem1);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = climber::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = static_cast<long long>(qm::kWaves) * sms * (per_sm > 0 ? per_sm : 1);
  qm::refine_plan_kernel<<<1, kThreads, 0, s>>>(sel_part, meta, q, mp, cap, splits, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* work = meta + q;
  void* args[] = {&data, &norms, &rec_dfs, &rec_gid, &queries, &sel_part,
                  &sel_lo, &sel_hi, &partial, &meta, &work, &mp, &cap, &n, &k,
                  const_cast<int*>(&vec4)};
  err = cudaLaunchKernel(kernel, dim3(splits, q), dim3(kThreads), args, smem1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = static_cast<size_t>(climber_refine_partial_merge_smem(splits, k));
  err = climber::allow_smem(qm::refine_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  qm::refine_merge_kernel<<<q, kMergeThreads, smem2, s>>>(
      partial, meta, sel_part, rec_gid, seen, sharing, out_d2, out_gid, splits, mp,
      cap, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(stats, sharing, 2 * sizeof(u64),
                                          cudaMemcpyDeviceToDevice, s));
}
