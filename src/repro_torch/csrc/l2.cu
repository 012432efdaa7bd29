// Pairwise squared L2 and per-query candidate dots.
//
// Replaces the two Pallas kernels of repro/kernels/l2.py:
//
//   * pairwise_l2 (_l2_kernel, the pallas_call at repro/kernels/l2.py:60):
//     q [Q, n] x x [C, n] -> [Q, C], max(|q|^2 - 2 q.x + |x|^2, 0) with fp32
//     FMA accumulation.  It is the exact scan (Dss) and so the ground truth
//     of every recall number: no TF32, no tensor cores, and out[i, j] sums
//     q_i . x_j, |q_i|^2 and |x_j|^2 each with fmaf in ascending k, so its
//     bits depend on n alone (not on Q, C, the chunk's row offset or the
//     block); there is no split-K.  Offsets are 64-bit.
//     Bound by fp32 operations: 2n FLOPs per output, 0.513 ms at the Dss
//     chunk [64, 256] x [2^20, 256] on an H100 (67 TFLOP/s; the 1.07 GB of
//     candidates alone take 0.32 ms at 3.35 TB/s).
//     The first design (a block per 64 x 128 output tile, both operand tiles
//     loaded through registers behind one barrier per 16-deep k step, a 4 x 8
//     register tile, 2-way conflicts on the transposing stores, and the same
//     64 KB query tile re-read by each of 8,192 blocks per chunk) took
//     1.419-1.432 ms there, 36% of the peak.
//     This design: a persistent grid, one 256-thread block per SM, walks
//     (query tile, candidate tile) items of 64 queries x 256 candidates.  The
//     block keeps its query tile k-major in shared memory (64 x 256 at
//     n <= 256; longer rows in 256-deep chunks) and |q|^2 beside it, loaded
//     once per query tile.  Candidate tiles stream row-major through a
//     2-slice ring of 256 x 64 slices filled by cp.async (16-byte copies,
//     zero-filled past the edges), so the next slice loads while the FMAs
//     run and while the epilogue writes; rows are padded to 68 floats, so
//     the float4 reads of 8 consecutive rows hit 32 distinct banks.  Each
//     thread keeps an 8 x 8 register tile (8 queries x 8 candidates, 16
//     float4 shared loads per 256 FMAs); every thread also sums the squares
//     of one tile row as its slices arrive.  The walk's bookkeeping divides
//     only when it moves to another item, and each 16-byte copy costs a
//     pointer step and a compare.  Odd n or unaligned rows take
//     4-byte copies into the same layout, with the same summation order.
//   * qdots (_qdots_kernel): q [Q, n], rows [Q, C, n] -> [Q, C], each query
//     against its own candidate rows (the dense refine's dot product).
//     Bound by HBM bytes: 2 FLOPs per 4 bytes of rows; 0.593 ms for the
//     smoke's q [60, 256], rows [60, 32208, 256] on an H100 (3.35 TB/s).
//     The first design (a block per (query, 64 rows), the query row staged
//     in shared memory behind a barrier, a warp reducing one row before it
//     loaded the next) took 0.672-0.716 ms there, 3-6% behind torch.bmm.
//     This design: a persistent grid whose warps walk (query, 4-row tile)
//     tasks in a grid-stride loop; a warp issues the streaming (__ldcs)
//     16-byte loads of all 4 rows before it reduces any of them, and keeps
//     the query row in registers (n <= 512 and n % 4 == 0: up to four
//     float4 a lane), reloading it only when its task moves to another
//     query.  Other n, or unaligned tensors, take a scalar-load kernel with
//     the same summation order.  That order: element e of a row goes to lane
//     (e / 4) % 32, which sums its elements in ascending e with fmaf; the
//     warp then sums by a butterfly.  It depends on n alone, so a row's dot
//     does not depend on the batch, the row's offset or the grid.
#include "climber_kernels.cuh"

namespace {

// ---- pairwise_l2 ---------------------------------------------------------
constexpr int kPQ = 64;                   // queries per query tile
constexpr int kPWarpsC = 4;               // warps along the candidates (x 2 along q)
constexpr int kPJ = 8;                    // candidates per thread (8 queries each)
constexpr int kPC = 8 * kPJ * kPWarpsC;   // candidates per candidate tile
constexpr int kPK = 64;                   // depth of one ring slice
constexpr int kPStages = 2;               // ring slices in flight
constexpr int kPKC = 256;                 // depth of the resident query chunk
constexpr int kPThreads = 64 * kPWarpsC;  // 2 x kPWarpsC warps
constexpr int kPNorm = kPC / kPThreads;   // tile rows whose |x|^2 a thread sums
constexpr int kPMinBlocks = 1;            // blocks per SM
constexpr int kQPitch = kPQ + 4;          // query chunk, k-major [kPKC][kQPitch]
constexpr int kCPitch = kPK + 4;          // ring slice, row-major [kPC][kCPitch]
constexpr size_t kPairSmem =
    sizeof(float) * (static_cast<size_t>(kPKC) * kQPitch +
                     static_cast<size_t>(kPStages) * kPC * kCPitch + kPQ);

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// A step of a block's walk: work item `item` (query tile qt, candidate rows
// from c0), ring slice ks of it, held in ring slot `slot`.  Advancing costs
// a division only when the item changes.
struct Cursor {
  long long item, qt, c0;
  int ks, slot;
  __device__ void locate(long long ctiles) {
    qt = item / ctiles;
    c0 = (item - qt * ctiles) * kPC;
  }
  __device__ void advance(int nk, long long ctiles) {
    slot = slot + 1 == kPStages ? 0 : slot + 1;
    if (++ks == nk) {
      ks = 0;
      item += gridDim.x;
      locate(ctiles);
    }
  }
};

// Issue the copies of ring slice `ks` (depth [ks * kPK, +kPK)) of candidate
// rows [c0, c0 + kPC) into dst, zero past C and past n.  With 16-byte
// copies a thread always takes the same column and every kRowStep-th row,
// so each copy costs a pointer step and a compare, not a row division.
constexpr int kQuadsPerRow = kPK / 4;
constexpr int kRowStep = kPThreads / kQuadsPerRow;
template <bool VEC>
__device__ __forceinline__ void load_slice(float* dst, const float* __restrict__ x,
                                           long long cn, int n, long long c0,
                                           int ks) {
  const int k0 = ks * kPK;
  if (VEC) {
    const int r0 = threadIdx.x / kQuadsPerRow, c4 = (threadIdx.x % kQuadsPerRow) * 4;
    const long long left = cn - c0 - r0;          // rows of this thread in range
    const bool col = k0 + c4 < n;
    const float* src = x + (c0 + r0) * n + k0 + c4;
    const long long step = static_cast<long long>(kRowStep) * n;
    float* d = dst + r0 * kCPitch + c4;
#pragma unroll
    for (int t = 0; t < kPC / kRowStep; ++t) {
      const bool full = col && t * kRowStep < left;
      cp_async16(d + t * kRowStep * kCPitch, full ? src : x, full);
      src += step;
    }
  } else {
    for (int i = threadIdx.x; i < kPC * kPK; i += kPThreads) {
      const int r = i / kPK, c = i % kPK;
      const bool full = c0 + r < cn && k0 + c < n;
      cp_async4(dst + r * kCPitch + c, full ? x + (c0 + r) * n + k0 + c : x, full);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kPThreads, kPMinBlocks)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int qn, long long cn, int n,
                   long long ctiles, long long items) {
  extern __shared__ __align__(16) float psm[];
  float* qs = psm;                                        // [kPKC][kQPitch]
  float* ring = qs + kPKC * kQPitch;                      // [kPStages][kPC][kCPitch]
  float* q2s = ring + kPStages * kPC * kCPitch;           // [kPQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wq = warp / kPWarpsC, wc = warp % kPWarpsC;  // 2 x kPWarpsC warps
  const int ty = lane >> 3, tx = lane & 7;                // 4 x 8 lanes
  const int qoff = wq * 32 + ty * 8;                      // this thread's 8 queries
  const int coff = wc * 8 * kPJ + tx;                     // ... and candidates coff + 8j
  const int nk = static_cast<int>(climber::ceil_div(n, kPK));
  const long long mine =
      blockIdx.x < items ? climber::ceil_div(items - blockIdx.x, gridDim.x) : 0;
  const long long steps = mine * nk;

  // two cursors over this block's (item, slice) steps: one for the slices
  // being computed, one kPStages - 1 steps ahead for the copies
  Cursor cur{blockIdx.x, 0, 0, 0, 0}, pf{blockIdx.x, 0, 0, 0, 0};
  cur.locate(ctiles);
  pf.locate(ctiles);
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < steps) load_slice<VEC>(ring + pf.slot * kPC * kCPitch, x, cn, n, pf.c0, pf.ks);
    pf.advance(nk, ctiles);
    cp_async_commit();
  }

  float acc[8][kPJ];
  float xn[kPNorm];                // |x|^2 of tile rows tid + i kPThreads, ascending k
  long long cur_qt = -1;
  int cur_chunk = -1;
  for (long long t = 0; t < steps; ++t, cur.advance(nk, ctiles)) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();               // slice t has landed; slice t - 1 is free
    if (t + kPStages - 1 < steps)
      load_slice<VEC>(ring + pf.slot * kPC * kCPitch, x, cn, n, pf.c0, pf.ks);
    pf.advance(nk, ctiles);
    cp_async_commit();
    const long long qt = cur.qt;
    const long long c0 = cur.c0;
    const int ks = cur.ks;
    const int k0 = ks * kPK;
    const int chunk = k0 / kPKC;
    if (qt != cur_qt || chunk != cur_chunk) {
      // (re)load the resident query chunk: every thread is past the barrier
      // above, so nobody still reads the old one
      const int kc0 = chunk * kPKC;
      for (int i = tid; i < kPQ * kPKC; i += kPThreads) {
        const int ql = i / kPKC, kl = i % kPKC;
        const long long gq = qt * kPQ + ql;
        qs[kl * kQPitch + ql] =
            gq < qn && kc0 + kl < n ? __ldg(q + gq * n + kc0 + kl) : 0.f;
      }
      if (qt != cur_qt && tid < kPQ) {
        const long long gq = qt * kPQ + tid;
        float a2 = 0.f;
        if (gq < qn)
          for (int k = 0; k < n; ++k) {
            const float v = __ldg(q + gq * n + k);
            a2 = fmaf(v, v, a2);
          }
        q2s[tid] = a2;
      }
      cur_qt = qt;
      cur_chunk = chunk;
      __syncthreads();
    }
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int r = 0; r < kPNorm; ++r) xn[r] = 0.f;
    }
    const float* bs = ring + cur.slot * kPC * kCPitch;
#pragma unroll
    for (int r = 0; r < kPNorm; ++r) {
      const float4* row = reinterpret_cast<const float4*>(bs + (tid + r * kPThreads) * kCPitch);
#pragma unroll
      for (int c = 0; c < kPK / 4; ++c) {
        const float4 v = row[c];
        xn[r] = fmaf(v.x, v.x, xn[r]);
        xn[r] = fmaf(v.y, v.y, xn[r]);
        xn[r] = fmaf(v.z, v.z, xn[r]);
        xn[r] = fmaf(v.w, v.w, xn[r]);
      }
    }
    const float* as = qs + (k0 - chunk * kPKC) * kQPitch + qoff;
#pragma unroll
    for (int kq = 0; kq < kPK / 4; ++kq) {
      float4 b[kPJ];
#pragma unroll
      for (int j = 0; j < kPJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + (coff + 8 * j) * kCPitch + kq * 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* ar = as + (kq * 4 + u) * kQPitch;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const float bj = lane_of(b[j], u);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], bj, acc[i][j]);
        }
      }
    }
    if (ks == nk - 1) {
      // epilogue: the ring's next slices are already in flight
      float* x2s = ring + cur.slot * kPC * kCPitch;
      __syncthreads();             // every thread is done with this slice
#pragma unroll
      for (int r = 0; r < kPNorm; ++r) x2s[tid + r * kPThreads] = xn[r];
      __syncthreads();
      const long long qbase = qt * kPQ + qoff;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (qbase + i >= qn) break;
        const float a2 = q2s[qoff + i];
        float* orow = out + (qbase + i) * cn + c0;
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const int cl = coff + 8 * j;
          if (c0 + cl < cn) orow[cl] = fmaxf(a2 - 2.f * acc[i][j] + x2s[cl], 0.f);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- qdots ---------------------------------------------------------------
constexpr int kQdThreads = 256;
constexpr int kQdRows = 4;                 // rows a warp loads before reducing

// Lane `lane` of the warp writes row c0 + lane of the tile (lanes < kQdRows).
__device__ __forceinline__ void qd_store(float* __restrict__ out, long long base,
                                         long long c0, long long cn, int lane,
                                         const float (&acc)[kQdRows]) {
  float v = acc[0];
#pragma unroll
  for (int r = 1; r < kQdRows; ++r) v = lane == r ? acc[r] : v;
  if (lane < kQdRows && c0 + lane < cn) out[base + c0 + lane] = v;
}

// n % 4 == 0, 16-byte aligned, n / 4 <= 32 * NV: the query row in registers.
template <int NV>
__global__ void __launch_bounds__(kQdThreads)
qdots_reg_kernel(const float4* __restrict__ q, const float4* __restrict__ rows,
                 float* __restrict__ out, long long cn, int n4, long long tiles,
                 long long tasks) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (kQdThreads / 32);
  long long cur = -1;
  float4 qv[NV];
  for (long long task = (blockIdx.x * static_cast<long long>(kQdThreads) +
                         threadIdx.x) / 32;
       task < tasks; task += nwarps) {
    const long long qi = task / tiles;
    const long long c0 = (task - qi * tiles) * kQdRows;
    if (qi != cur) {
      cur = qi;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = lane + 32 * v;
        qv[v] = j < n4 ? __ldg(q + qi * n4 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float4 xv[kQdRows][NV];
#pragma unroll
    for (int r = 0; r < kQdRows; ++r)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = lane + 32 * v;
        xv[r][v] = (c0 + r < cn && j < n4)
                       ? __ldcs(rows + (qi * cn + c0 + r) * n4 + j)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    float acc[kQdRows];
#pragma unroll
    for (int r = 0; r < kQdRows; ++r) {
      acc[r] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (lane + 32 * v < n4) {
          acc[r] = fmaf(xv[r][v].x, qv[v].x, acc[r]);
          acc[r] = fmaf(xv[r][v].y, qv[v].y, acc[r]);
          acc[r] = fmaf(xv[r][v].z, qv[v].z, acc[r]);
          acc[r] = fmaf(xv[r][v].w, qv[v].w, acc[r]);
        }
      }
      acc[r] = climber::warp_sum(acc[r]);
    }
    qd_store(out, qi * cn, c0, cn, lane, acc);
  }
}

// Any n, any alignment: scalar loads, the same summation order.
__global__ void __launch_bounds__(kQdThreads)
qdots_any_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                 float* __restrict__ out, long long cn, int n, long long tiles,
                 long long tasks) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (kQdThreads / 32);
  for (long long task = (blockIdx.x * static_cast<long long>(kQdThreads) +
                         threadIdx.x) / 32;
       task < tasks; task += nwarps) {
    const long long qi = task / tiles;
    const long long c0 = (task - qi * tiles) * kQdRows;
    const float* qrow = q + qi * n;
    float acc[kQdRows];
#pragma unroll
    for (int r = 0; r < kQdRows; ++r) acc[r] = 0.f;
    for (int e0 = 4 * lane; e0 < n; e0 += 128) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = e0 + t;
        if (e < n) {
          const float qe = __ldg(qrow + e);
#pragma unroll
          for (int r = 0; r < kQdRows; ++r)
            if (c0 + r < cn)
              acc[r] = fmaf(__ldcs(rows + (qi * cn + c0 + r) * n + e), qe, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kQdRows; ++r) acc[r] = climber::warp_sum(acc[r]);
    qd_store(out, qi * cn, c0, cn, lane, acc);
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A persistent grid of `kernel` over `tasks` warp tasks.
template <typename Q, typename R>
cudaError_t launch_qdots(void (*kernel)(const Q*, const R*, float*, long long, int,
                                        long long, long long),
                         long long tasks, cudaStream_t s, const Q* q, const R* rows,
                         float* out, long long cn, int n, long long tiles) {
  unsigned blocks = 0;
  cudaError_t err = climber::persistent_blocks(
      kernel, kQdThreads, 0, climber::ceil_div(tasks, kQdThreads / 32), &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kQdThreads, 0, s>>>(q, rows, out, cn, n, tiles, tasks);
  return cudaGetLastError();
}

}  // namespace

CLIMBER_API int climber_pairwise_l2(const float* q, const float* x, float* out,
                                    int qn, long long cn, int n, void* stream) {
  if (qn <= 0 || cn <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctiles = climber::ceil_div(cn, kPC);
  const long long items = climber::ceil_div(qn, kPQ) * ctiles;
  const bool vec = n % 4 == 0 && aligned16(x);
  auto kernel = vec ? pairwise_l2_kernel<true> : pairwise_l2_kernel<false>;
  cudaError_t err = climber::allow_smem(kernel, kPairSmem);
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = climber::persistent_blocks(kernel, kPThreads, kPairSmem, items, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kPThreads, kPairSmem, static_cast<cudaStream_t>(stream)>>>(
      q, x, out, qn, cn, n, ctiles, items);
  return static_cast<int>(cudaGetLastError());
}

CLIMBER_API int climber_qdots(const float* q, const float* rows, float* out,
                              int qn, long long cn, int n, void* stream) {
  if (qn <= 0 || cn <= 0) return static_cast<int>(cudaSuccess);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = climber::ceil_div(cn, kQdRows);
  const long long tasks = qn * tiles;
  const int n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n % 4 || n4 > 128 || !aligned16(q) || !aligned16(rows)) {
    err = launch_qdots(qdots_any_kernel, tasks, s, q, rows, out, cn, n, tiles);
  } else {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* r4 = reinterpret_cast<const float4*>(rows);
    switch ((n4 + 31) / 32) {
      case 1: err = launch_qdots(qdots_reg_kernel<1>, tasks, s, q4, r4, out, cn, n4, tiles); break;
      case 2: err = launch_qdots(qdots_reg_kernel<2>, tasks, s, q4, r4, out, cn, n4, tiles); break;
      case 3: err = launch_qdots(qdots_reg_kernel<3>, tasks, s, q4, r4, out, cn, n4, tiles); break;
      default: err = launch_qdots(qdots_reg_kernel<4>, tasks, s, q4, r4, out, cn, n4, tiles);
    }
  }
  return static_cast<int>(err);
}
