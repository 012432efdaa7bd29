// Streaming fused refine: masked squared ED + k-best, straight off the
// partition store, with no gather and no [Q, MP, cap] distance tensor.
//
// Replaces the Pallas kernel repro/kernels/refine_topk.py::refine_topk
// (_refine_topk_kernel).  For query q and plan entry s (the plan sorted by
// partition id, pads first) the candidates are the cap slots of partition
// sel_part[q, s]; slot c has the flat index f = s * cap + c.  A record is
// kept iff gid >= 0, sel_lo <= dfs < sel_hi, and no earlier entry of the same
// partition covers it (the segment dedupe of core/refine.py).  Its squared
// distance is max(|q|^2 - 2 q.x + |x|^2, 0).  The output is the k best by
// the key (d2, f): ties go to the lowest flat index, as jax.lax.top_k gives.
//
// Bound by HBM bytes: 2n FLOPs per 4n + 12 bytes of each kept record.
//
// The Pallas body walks a sequential grid and unrolls k argmin steps; at the
// paper's K = 500 that cannot stand, and Hopper blocks run in no order.  So:
//   * refine_partial_kernel, grid (splits, Q): each block loads the query and
//     its whole sorted plan row into shared memory, so it can evaluate the
//     dedupe predicate for any entry alone, and takes one contiguous share of
//     the query's live flat range.  Pad entries sort first and are skipped
//     without touching the store.  Per tile of 256 slots every thread tests
//     one slot (dfs and gid reads, coalesced); the kept slots are compacted
//     into a list, and each warp computes the distances of four kept rows at
//     a time with 16-byte loads.  A distance whose 64-bit key
//     (float bits of d2 << 32 | f) beats the block's current k-th key goes to
//     a buffer; a full buffer is merged into the block's k-best by a bitonic
//     sort in shared memory.
//   * refine_merge_kernel, grid Q: sorts the splits' k-best lists together
//     by the same key and writes (d2, gid), +3.4e38 / -1 where fewer than k
//     candidates exist.  The key is exact, so the answer does not depend on
//     the number of splits or on the order in which blocks finish.
#include "climber_kernels.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;                // slots tested per tile
constexpr int kRowsPerWarp = 4;           // rows in flight per warp
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

__global__ void refine_partial_kernel(
    const float* __restrict__ data, const float* __restrict__ norms,
    const int* __restrict__ rec_dfs, const int* __restrict__ rec_gid,
    const float* __restrict__ queries, const int* __restrict__ sel_part,
    const int* __restrict__ sel_lo, const int* __restrict__ sel_hi,
    u64* __restrict__ partial, int mp, int cap, int n, int k, int L,
    int vec4) {
  const int q = blockIdx.y;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);               // [L]
  float* q_s = reinterpret_cast<float*>(keys + L);        // [n4 * 4]
  const int n_pad = (n + 3) & ~3;
  int* sp_s = reinterpret_cast<int*>(q_s + n_pad);        // [mp]
  int* lo_s = sp_s + mp;
  int* hi_s = lo_s + mp;
  int* seg_s = hi_s + mp;                                 // segment start
  int* ev = seg_s + mp;                                   // [kTile]
  __shared__ int s_nev, s_nbuf, s_npad;
  __shared__ u64 s_thresh;
  __shared__ float s_q2;

  const float* qrow = queries + static_cast<long long>(q) * n;
  for (int i = tid; i < n_pad; i += kThreads) q_s[i] = i < n ? qrow[i] : 0.f;
  for (int s = tid; s < mp; s += kThreads) {
    sp_s[s] = sel_part[q * mp + s];
    lo_s[s] = sel_lo[q * mp + s];
    hi_s[s] = sel_hi[q * mp + s];
  }
  for (int i = tid; i < L; i += kThreads) keys[i] = kEmpty;
  if (tid == 0) {
    s_nbuf = 0;
    s_npad = 0;
    s_thresh = kEmpty;
  }
  __syncthreads();
  int npad_local = 0;
  for (int s = tid; s < mp; s += kThreads) {
    int t = s;
    while (t > 0 && sp_s[t - 1] == sp_s[s]) --t;
    seg_s[s] = t;
    npad_local += sp_s[s] < 0;
  }
  if (npad_local) atomicAdd(&s_npad, npad_local);
  if (warp == 0) {
    float acc = 0.f;
    for (int i = lane; i < n; i += 32) acc = fmaf(q_s[i], q_s[i], acc);
    acc = climber::warp_sum(acc);
    if (lane == 0) s_q2 = acc;
  }
  __syncthreads();

  // this block's share of the live flat range (pads sort first)
  const int first_live = s_npad;
  const long long live = static_cast<long long>(mp - first_live) * cap;
  const long long chunk = climber::ceil_div(live, splits);
  const long long begin = static_cast<long long>(first_live) * cap +
                          split * chunk;
  const long long end_ll = begin + chunk < static_cast<long long>(mp) * cap
                               ? begin + chunk
                               : static_cast<long long>(mp) * cap;
  const int end = static_cast<int>(end_ll);
  const float q2 = s_q2;
  const int limit = L - k - kTile;   // merge before a tile could overflow

  for (long long base_ll = begin; base_ll < end_ll; base_ll += kTile) {
    const int base = static_cast<int>(base_ll);
    __syncthreads();                   // previous tile fully consumed
    if (tid == 0) s_nev = 0;
    if (s_nbuf > limit) {
      for (int i = k + s_nbuf + tid; i < L; i += kThreads) keys[i] = kEmpty;
      bitonic_sort(keys, L);
      if (tid == 0) {
        s_nbuf = 0;
        s_thresh = keys[k - 1];
      }
    }
    __syncthreads();

    // phase A: one slot per thread — inclusion predicate, then compaction
    const int f = base + tid;
    if (f < end) {
      const int s = f / cap;
      const int c = f - s * cap;
      const long long slot = static_cast<long long>(sp_s[s]) * cap + c;
      const int gid = __ldg(rec_gid + slot);
      const int dfs = __ldg(rec_dfs + slot);
      bool keep = gid >= 0 && dfs >= lo_s[s] && dfs < hi_s[s];
      for (int t = seg_s[s]; keep && t < s; ++t)
        if (dfs >= lo_s[t] && dfs < hi_s[t]) keep = false;
      if (keep) ev[atomicAdd(&s_nev, 1)] = f;
    }
    __syncthreads();

    // phase B: distances of the kept rows, kRowsPerWarp rows per warp
    const int nev = s_nev;
    for (int e0 = warp * kRowsPerWarp; e0 < nev; e0 += kWarps * kRowsPerWarp) {
      long long slot[kRowsPerWarp];
      float acc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int e = e0 + r < nev ? e0 + r : e0;   // repeat a live row
        const int fr = ev[e];
        const int s = fr / cap;
        slot[r] = static_cast<long long>(sp_s[s]) * cap + (fr - s * cap);
        acc[r] = 0.f;
      }
      if (vec4) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int j = lane; j < n / 4; j += 32) {
          const float4 qq = q4[j];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(
                                       data + slot[r] * n) + j);
            acc[r] = fmaf(x.x, qq.x, acc[r]);
            acc[r] = fmaf(x.y, qq.y, acc[r]);
            acc[r] = fmaf(x.z, qq.z, acc[r]);
            acc[r] = fmaf(x.w, qq.w, acc[r]);
          }
        }
      } else {
        for (int j = lane; j < n; j += 32) {
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r] = fmaf(__ldg(data + slot[r] * n + j), q_s[j], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = climber::warp_sum(acc[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (e0 + r >= nev) break;
          float d2 = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, acc[r])),
                               __ldg(norms + slot[r]));
          d2 = d2 > 0.f ? d2 : 0.f;
          const u64 key = make_key(d2, ev[e0 + r]);
          if (key < s_thresh) keys[k + atomicAdd(&s_nbuf, 1)] = key;
        }
      }
    }
  }

  __syncthreads();
  if (s_nbuf > 0) {
    for (int i = k + s_nbuf + tid; i < L; i += kThreads) keys[i] = kEmpty;
    bitonic_sort(keys, L);
  }
  u64* out = partial + (static_cast<long long>(q) * splits + split) * k;
  for (int i = tid; i < k; i += kThreads) out[i] = keys[i];
}

__global__ void refine_merge_kernel(const u64* __restrict__ partial,
                                    const int* __restrict__ sel_part,
                                    const int* __restrict__ rec_gid,
                                    float* __restrict__ out_d2,
                                    int* __restrict__ out_gid, int splits,
                                    int mp, int cap, int k, int L) {
  const int q = blockIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  const u64* src = partial + static_cast<long long>(q) * splits * k;
  const int total = splits * k;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    keys[i] = i < total ? src[i] : kEmpty;
  bitonic_sort(keys, L);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const u64 key = keys[i];
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

int next_pow2(long long v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

// Shared memory the two kernels need for a call (bytes); the wrapper checks
// these against the card's limit before it picks the number of splits.
CLIMBER_API long long climber_refine_partial_smem(int mp, int n, int k) {
  const int L = next_pow2(static_cast<long long>(k) + 4 * kTile);
  return static_cast<long long>(L) * 8 + 4LL * ((n + 3) & ~3) +
         16LL * mp + 4LL * kTile;
}

CLIMBER_API long long climber_refine_merge_smem(int splits, int k) {
  return static_cast<long long>(
             next_pow2(static_cast<long long>(splits) * k)) * 8;
}

// partial: [q, splits, k] u64 scratch; out_d2 / out_gid: [q, k].
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
  const int L = next_pow2(static_cast<long long>(k) + 4 * kTile);
  const size_t smem1 = static_cast<size_t>(climber_refine_partial_smem(mp, n, k));
  cudaError_t err = climber::allow_smem(refine_partial_kernel, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(data) % 16 == 0);
  refine_partial_kernel<<<dim3(splits, q), kThreads, smem1, s>>>(
      data, norms, rec_dfs, rec_gid, queries, sel_part, sel_lo, sel_hi,
      partial, mp, cap, n, k, L, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L2 = next_pow2(static_cast<long long>(splits) * k);
  const size_t smem2 = static_cast<size_t>(L2) * 8;
  err = climber::allow_smem(refine_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  refine_merge_kernel<<<q, kThreads, smem2, s>>>(
      partial, sel_part, rec_gid, out_d2, out_gid, splits, mp, cap, k, L2);
  return static_cast<int>(cudaGetLastError());
}
