// Fused pivot distances + top-m prefix: the P4-> signature of paper Def. 5.
//
// Replaces the Pallas kernel repro/kernels/pivot_rank.py::pivot_rank
// (_pivot_rank_kernel): squared distances max(|x|^2 - 2 x.p + |p|^2, 0) from
// each [w] PAA row to the [r, w] pivots, then the ids of the m nearest,
// nearest first, ties to the lower pivot id.  The distances use fp32 FMA, not
// TF32: the signature is an integer result and has to match.
//
// Bound by fp32 operations: (2w + 3) r FLOPs per row against 4w bytes read
// and 4m written (r = 200, w = 16: 7000 FLOPs per 104 bytes); 0.438 ms at
// [2^22, 16] x [200, 16] on an H100 (67 TFLOP/s of non-tensor fp32).
//
// The first design (a thread per row inserting into its list at every pivot
// that beat its m-th distance, divergent across the warp) took 13.75-13.86 ms
// there, and 0.17 ms of device time for a 64-row query batch.
//
// This design:
//   * a group of G lanes owns a row (G a power of two, picked from the batch
//     so that the grid fills the card: 1 for the build's 2^18-row chunks, 32
//     for a 64-row query batch); lane s of the group scans pivots s, s + G,
//     ... in ascending id and keeps its own sorted top-m list in registers;
//   * the list length is a template constant, exact for w = 16, m = 10 (the
//     paper configuration's) and 16 / 32 for any other w or m (the kNN-LM's
//     m = 6 runs the 16-entry list); with G = 1 the exact list takes
//     kRows = 2 rows per lane, so that each pivot word read from shared
//     memory feeds two rows' FMAs;
//   * the lane computes the distances of kChunk = 16 pivots, stages them in
//     shared memory and marks those that beat its current m-th distance
//     (branch-free); then, while a warp vote says some lane still holds a
//     mark, every lane takes its lowest marked pivot and shifts it into its
//     list branch-free (a mark the list no longer admits changes nothing),
//     loading the next mark's distance before the shift.  A row admits
//     about m + m ln(r / m) = 40 entries (pivots in random order); a warp
//     runs as many rounds per chunk as its busiest lane needs, off the
//     per-pivot path;
//   * a candidate enters only on a strictly smaller distance, and a lane sees
//     its pivots in ascending id, so each list is ordered by (distance, id);
//     the G lists then merge in m rounds of a shuffle argmin on (distance, id)
//     within the group, which keeps the lower id first on ties.
// The pivots sit in shared memory pivot-major, scaled by -2 (exact, so the
// distances are bit for bit those of the first design), with |p|^2 beside
// them at a pitch of w/4 + 1 16-byte words (a broadcast when G = 1; for
// w >= 8 the G lanes of a group fall on different banks), padded to whole
// chunks with pivots of infinite norm.  The grid is persistent: each block
// stages the pivots once and walks row tiles.  What limits it: the merge
// rounds take about 45% of the time at [2^22, 16] (the distance pass alone
// runs in 0.94 ms of 1.72), and a warp pays for its busiest lane in each.
#include <math.h>

#include "climber_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;                 // pivots per lane between merges
constexpr int kRows = 2;                   // rows per lane of the exact list, G = 1
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = 0x7fffffff;
constexpr size_t kSmemLimit = 232448;      // what one block may use on Hopper

// Blocks per SM that the register budget is set for: for the paper's w = 16,
// m = 10, three with a row per lane (at most 80 registers a thread; four
// spill) and two with two rows (at most 128); else what the compiler needs.
// tools/pivot_rank_variants.py times the alternatives.
constexpr int min_blocks(int w, int m, int rows) {
  return w <= 16 && m <= 10 ? (rows == 1 ? 3 : 2) : 1;
}

// Shared memory: the pivots padded to whole chunks of every lane, as
// [slots][w/4 + 1] float4 (-2p in the first w/4 words, |p|^2 in .x of the
// last), then the chunk's distances, [rows][kChunk][kThreads] floats.
inline size_t smem_bytes(int w, int r, int g, int rows) {
  const long long step = static_cast<long long>(g) * kChunk;
  const long long slots = climber::ceil_div(r, step) * step;
  return static_cast<size_t>(slots) * (w / 4 + 1) * 16 +
         static_cast<size_t>(rows) * kChunk * kThreads * 4;
}

// The list's m-th distance: bd[M - 1] when the list length is exactly m,
// else the largest of the first m (a max, not an index by m, which the
// compiler would put in local memory).
template <int M, bool EXACT>
__device__ __forceinline__ float kth(const float (&bd)[M], int m) {
  if (EXACT) return bd[M - 1];
  float v = bd[0];
#pragma unroll
  for (int t = 1; t < M; ++t) v = fmaxf(v, t < m ? bd[t] : v);
  return v;
}

// Insert (cd, ci) into the list sorted by (distance, id), dropping its last
// entry: positions at and after the first one cd beats shift down by one.
// ci is larger than every id in the list, so a tie never enters; cd = +inf
// leaves the list as it is.
template <int M>
__device__ __forceinline__ void insert(float (&bd)[M], int (&bi)[M], float cd,
                                       int ci) {
#pragma unroll
  for (int t = M - 1; t >= 0; --t) {
    const bool here = cd < bd[t];
    const bool above = t > 0 && cd < bd[t > 0 ? t - 1 : 0];
    const float nd = above ? bd[t > 0 ? t - 1 : 0] : cd;
    const int ni = above ? bi[t > 0 ? t - 1 : 0] : ci;
    bd[t] = here ? nd : bd[t];
    bi[t] = here ? ni : bi[t];
  }
}

// R rows per lane: each pivot word read from shared memory feeds R FMAs.
template <int W, int M, bool EXACT, int R>
__global__ void __launch_bounds__(kThreads, min_blocks(W, M, R))
pivot_rank_kernel(const float* __restrict__ paa,
                  const float* __restrict__ pivots, int* __restrict__ out,
                  long long b, int r, int m, int g) {
  constexpr int W4 = W / 4;
  constexpr int PITCH = W4 + 1;
  extern __shared__ float4 smem4[];
  const int step = g * kChunk;                    // pivots per chunk per group
  const int chunks = (r + step - 1) / step;
  const int slots = chunks * step;
  float4* sp = smem4;                             // [slots][PITCH]
  float* sd = reinterpret_cast<float*>(smem4 + slots * PITCH) + threadIdx.x;
  for (int i = threadIdx.x; i < slots * W4; i += kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < r * W4) {
      // -2p is exact, so x.(-2p) is -2 (x.p) bit for bit
      const float* p = pivots + 4 * i;
      v = make_float4(-2.f * __ldg(p), -2.f * __ldg(p + 1), -2.f * __ldg(p + 2),
                      -2.f * __ldg(p + 3));
    }
    sp[(i / W4) * PITCH + i % W4] = v;
  }
  for (int j = threadIdx.x; j < slots; j += kThreads) {
    float acc = INFINITY;                         // a pad: never a candidate
    if (j < r) {
      acc = 0.f;
#pragma unroll
      for (int t = 0; t < W; ++t) {
        const float v = __ldg(pivots + j * W + t);
        acc = fmaf(v, v, acc);
      }
    }
    sp[j * PITCH + W4] = make_float4(acc, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int sub = threadIdx.x & (g - 1);
  const int groups = kThreads / g;                // row slots of a block
  const long long rows_per_block = static_cast<long long>(groups) * R;
  for (long long row0 = blockIdx.x * rows_per_block; row0 < b;
       row0 += static_cast<long long>(gridDim.x) * rows_per_block) {
    float x[R][W];
    float x2[R];
    float bd[R][M];
    int bi[R][M];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long row = row0 + q * groups + threadIdx.x / g;
      x2[q] = 0.f;
#pragma unroll
      for (int t = 0; t < W; ++t) {
        x[q][t] = row < b ? __ldg(paa + row * W + t) : 0.f;
        x2[q] = fmaf(x[q][t], x[q][t], x2[q]);
      }
#pragma unroll
      for (int t = 0; t < M; ++t) {
        bd[q][t] = INFINITY;
        bi[q][t] = kNoId;
      }
    }

    for (int c = 0; c < chunks; ++c) {
      const int j0 = c * step + sub;              // this lane's pivots: j0 + i g
      const float4* pc = sp + j0 * PITCH;
      float worst[R];
      unsigned cand[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const bool live = row0 + q * groups + threadIdx.x / g < b;
        worst[q] = live ? kth<M, EXACT>(bd[q], m) : -INFINITY;
        cand[q] = 0;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4* p = pc + i * g * PITCH;
        float ab[R];
#pragma unroll
        for (int q = 0; q < R; ++q) ab[q] = 0.f;
#pragma unroll
        for (int t = 0; t < W4; ++t) {
          const float4 v = p[t];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            ab[q] = fmaf(x[q][4 * t], v.x, ab[q]);
            ab[q] = fmaf(x[q][4 * t + 1], v.y, ab[q]);
            ab[q] = fmaf(x[q][4 * t + 2], v.z, ab[q]);
            ab[q] = fmaf(x[q][4 * t + 3], v.w, ab[q]);
          }
        }
        const float p2 = p[W4].x;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float d = fmaxf(__fadd_rn(__fadd_rn(x2[q], ab[q]), p2), 0.f);
          sd[(q * kChunk + i) * kThreads] = d;
          cand[q] |= static_cast<unsigned>(d < worst[q]) << i;
        }
      }
      // merge while any lane of the warp still holds a candidate: each round
      // inserts every row's lowest one (+inf: none) and loads the next one's
      // distance first, so that the load's latency hides behind the insert
      float cd[R];
      int ci[R];
      bool more = false;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int first = __ffs(cand[q]) - 1;     // -1: this row has none
        cand[q] &= cand[q] - 1;
        const float d = sd[(q * kChunk + (first & (kChunk - 1))) * kThreads];
        cd[q] = first >= 0 ? d : INFINITY;
        ci[q] = j0 + first * g;
        more |= first >= 0;
      }
      while (__any_sync(kFull, more)) {
        more = false;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int next = __ffs(cand[q]) - 1;
          cand[q] &= cand[q] - 1;
          const float d = sd[(q * kChunk + (next & (kChunk - 1))) * kThreads];
          insert<M>(bd[q], bi[q], cd[q], ci[q]);
          cd[q] = next >= 0 ? d : INFINITY;
          ci[q] = j0 + next * g;
          more |= next >= 0;
        }
      }
    }

#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long row = row0 + q * groups + threadIdx.x / g;
      const bool live = row < b;
      if (g == 1) {
#pragma unroll
        for (int t = 0; t < M; ++t)
          if (live && t < m) out[row * m + t] = bi[q][t];
        continue;
      }
      // merge the group's g lists: m rounds of argmin on (distance, id)
#pragma unroll
      for (int k = 0; k < M; ++k) {
        if (k >= m) break;
        float md = bd[q][0];
        int mi = bi[q][0];
        for (int off = 1; off < g; off <<= 1) {
          const float od = __shfl_xor_sync(kFull, md, off);
          const int oi = __shfl_xor_sync(kFull, mi, off);
          const bool take = od < md || (od == md && oi < mi);
          md = take ? od : md;
          mi = take ? oi : mi;
        }
        const bool pop = bi[q][0] == mi;          // ids are unique within a group
#pragma unroll
        for (int t = 0; t < M - 1; ++t) {
          bd[q][t] = pop ? bd[q][t + 1] : bd[q][t];
          bi[q][t] = pop ? bi[q][t + 1] : bi[q][t];
        }
        bd[q][M - 1] = pop ? INFINITY : bd[q][M - 1];
        bi[q][M - 1] = pop ? kNoId : bi[q][M - 1];
        if (live && sub == 0) out[row * m + k] = mi;
      }
    }
  }
}

// Lanes per row when the caller leaves it to the kernel (g = 0): enough
// lanes for about 1024 a SM, if the pivots, padded for them, still fit.
int pick_lanes(int w, long long b, int r, int sms) {
  int g = 1;
  while (g < 32 && b * g < 1024LL * sms && smem_bytes(w, r, 2 * g, 1) <= kSmemLimit)
    g *= 2;
  return g;
}

template <int W, int M, bool EXACT, int R>
cudaError_t launch(const float* paa, const float* pivots, int* out,
                   long long b, int r, int m, int g, cudaStream_t stream) {
  auto kernel = pivot_rank_kernel<W, M, EXACT, R>;
  const size_t smem = smem_bytes(W, r, g, R);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = climber::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  unsigned blocks = 0;
  err = climber::persistent_blocks(kernel, kThreads, smem,
                                   climber::ceil_div(b, kThreads / g * R), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(paa, pivots, out, b, r, m, g);
  return cudaGetLastError();
}

// Rows per lane: kRows for the exact list with a lane per row, else one.
constexpr int rows_for(int w, int m, int g) { return w == 16 && m == 10 && g == 1 ? kRows : 1; }

template <int W>
cudaError_t launch_w(const float* paa, const float* pivots, int* out,
                     long long b, int r, int m, int g, cudaStream_t stream) {
  if constexpr (W == 16) {
    if (m == 10 && g == 1)
      return launch<W, 10, true, kRows>(paa, pivots, out, b, r, m, g, stream);
    if (m == 10) return launch<W, 10, true, 1>(paa, pivots, out, b, r, m, g, stream);
  }
  if (m <= 16) return launch<W, 16, false, 1>(paa, pivots, out, b, r, m, g, stream);
  return launch<W, 32, false, 1>(paa, pivots, out, b, r, m, g, stream);
}

}  // namespace

// Shared memory the kernel needs at least (one lane per row); the wrapper
// refuses pivots that do not fit.
CLIMBER_API long long climber_pivot_rank_smem(int w, int r, int m) {
  return static_cast<long long>(smem_bytes(w, r, 1, rows_for(w, m, 1)));
}

// Supported widths: w in {4, 8, 16, 32, 64}, m <= 32, m <= r, and pivots
// that fit in shared memory.  g lanes per row: 1, 2, 4, 8, 16 or 32, or 0 to
// pick from b (what the wrapper passes; the card tests force each g).
CLIMBER_API int climber_pivot_rank(const float* paa, const float* pivots,
                                   int* out, long long b, int w, int r, int m,
                                   int g, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if (m < 1 || m > 32 || m > r || g < 0 || g > 32 || (g & (g - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0) {
    int sms = 0;
    const cudaError_t err = climber::sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    g = pick_lanes(w, b, r, sms);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 4: err = launch_w<4>(paa, pivots, out, b, r, m, g, s); break;
    case 8: err = launch_w<8>(paa, pivots, out, b, r, m, g, s); break;
    case 16: err = launch_w<16>(paa, pivots, out, b, r, m, g, s); break;
    case 32: err = launch_w<32>(paa, pivots, out, b, r, m, g, s); break;
    case 64: err = launch_w<64>(paa, pivots, out, b, r, m, g, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
