// Streaming fused refine: masked squared ED + k-best, straight off the
// partition store, with no gather and no [Q, MP, cap] distance tensor.
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
// (4n + 4 bytes) plus 8 bytes of tags per live slot; 0.138 ms for the
// smoke's adaptive batch (Q = 64, 8 live entries, cap 4,026, n = 256,
// k = 500: 432,842 distinct kept records) on an H100 at 3.35 TB/s.
//
// The first design (a fixed number of blocks per query, each walking its
// share in 256-slot tiles of three barrier-separated steps: tag test and
// compaction, four rows per warp, a key insert by lane 0; a bitonic sort of
// 2,048 keys per block; a merge kernel that bitonic-sorted next_pow2(splits
// x k) keys per query) took 0.50-0.52 ms there, and 1.30 ms on the next
// batch, whose heaviest query has 52 live entries against 8: every query got
// the same 9 blocks, so that query's blocks set the time.
//
// This design, three kernels:
//   * refine_plan_kernel (one block): each query's pad count and its number
//     of blocks, in proportion to its live slots, for about kWaves resident
//     grids of blocks over the batch (at least one per query, at most
//     `splits`); it also zeroes each query's chunk counter.
//   * refine_partial_kernel, grid (splits, Q), blocks past their query's
//     count exit at once.  A block keeps the query and the live entries of
//     its plan row with their dedupe segments in shared memory, then takes
//     2,048-slot chunks of the query's live flat range from the counter it
//     shares with the query's other blocks, until none is left.  A chunk's
//     tags are tested with eight (gid, dfs) pairs in flight per thread, and
//     the kept flat indices are compacted (one ballot and one atomic per
//     warp) into a list of up to 4,096.  When the list could not take
//     another chunk, or the range is done, every warp streams the listed
//     rows 8 at a time, their norms and all their 16-byte streaming loads
//     issued before any reduction (two float4 per lane per row at n <= 256),
//     with no barrier until the list is done.  A row's dot is summed in one fixed
//     order (lane l takes float4 l, l + 32, ... in turn with fmaf, then a
//     butterfly), the first design's, so a distance's bits depend on n
//     alone.  Keys below the block's k-th key go warp by warp to a
//     4,096-key buffer; a buffer that could not take the next list is
//     bitonic-sorted at its own length and merged into the sorted k-best by
//     merge path.  More, smaller blocks than one resident grid (kWaves = 4)
//     keep the card's blocks out of step, so some stream rows while others
//     test tags or merge.
//   * refine_merge_kernel, grid Q: the query's sorted partial lists are
//     merged pairwise by merge path, keeping k per pair, in ceil(log2 s)
//     rounds, each thread placing runs of 8 outputs after one binary
//     search; then (d2, gid), with 3.4e38 / -1 past the pool.
// The key is exact, so the answer does not depend on the number of blocks,
// on which block took which chunk, or on the order in which they finish.
#include "climber_kernels.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kScanPer = 8;               // tag pairs in flight per thread
constexpr int kScan = kThreads * kScanPer;   // slots per tag pass
constexpr int kEv = 4096;                 // kept flat indices held at once
constexpr int kBuf = 4096;                // candidate keys before a merge
constexpr long long kMinChunk = 2048;     // fewest live slots per block
constexpr int kWaves = 4;                 // blocks per batch, in resident grids
constexpr int kRun = 8;                   // merge outputs per thread task
constexpr int kMergeThreads = 512;
constexpr u64 kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr float kPadDist = 3.4e38f;

__device__ __forceinline__ u64 make_key(float d2, int flat) {
  return (static_cast<u64>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned>(flat);
}

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
                                    float* __restrict__ out_d2,
                                    int* __restrict__ out_gid, int splits,
                                    int mp, int cap, int k) {
  const int q = blockIdx.x;
  const int lists = static_cast<int>(meta[q] >> 32);
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

}  // namespace

// Shared memory the two kernels need for a call (bytes); the wrapper checks
// these against the card's limit before it picks the number of splits.
CLIMBER_API long long climber_refine_partial_smem(int mp, int n, int k) {
  return 8LL * (2LL * k + kBuf) + 4LL * kEv + 4LL * ((n + 3) & ~3) + 16LL * mp;
}

CLIMBER_API long long climber_refine_merge_smem(int splits, int k) {
  return 16LL * splits * k;
}

// partial: [q * splits * k + 2 * q] u64 scratch (the partial lists, then
// each query's plan summary, then its chunk counter); out_d2 / out_gid:
// [q, k].  `splits` is the most
// blocks a query may get.
CLIMBER_API int climber_refine_topk(
    const float* data, const float* norms, const int* rec_dfs,
    const int* rec_gid, const float* queries, const int* sel_part,
    const int* sel_lo, const int* sel_hi, unsigned long long* partial,
    float* out_d2, int* out_gid, int q, int mp, int cap, int n, int k,
    int splits, void* stream) {
  if (q <= 0) return static_cast<int>(cudaSuccess);
  if (mp <= 0 || cap <= 0 || n <= 0 || k <= 0 || splits <= 0 ||
      static_cast<long long>(mp) * cap >= 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* meta = partial + static_cast<long long>(q) * splits * k;
  const int vec4 = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(data) % 16 == 0);
  const void* kernel = partial_kernel_for(n, vec4);
  const size_t smem1 = static_cast<size_t>(climber_refine_partial_smem(mp, n, k));
  cudaError_t err = climber::allow_smem(kernel, smem1);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = climber::sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long target = static_cast<long long>(kWaves) * sms * (per_sm > 0 ? per_sm : 1);
  refine_plan_kernel<<<1, kThreads, 0, s>>>(sel_part, meta, q, mp, cap, splits, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* work = meta + q;
  void* args[] = {&data, &norms, &rec_dfs, &rec_gid, &queries, &sel_part,
                  &sel_lo, &sel_hi, &partial, &meta, &work, &mp, &cap, &n, &k,
                  const_cast<int*>(&vec4)};
  err = cudaLaunchKernel(kernel, dim3(splits, q), dim3(kThreads), args, smem1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = static_cast<size_t>(climber_refine_merge_smem(splits, k));
  err = climber::allow_smem(refine_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  refine_merge_kernel<<<q, kMergeThreads, smem2, s>>>(
      partial, meta, sel_part, rec_gid, out_d2, out_gid, splits, mp, cap, k);
  return static_cast<int>(cudaGetLastError());
}
