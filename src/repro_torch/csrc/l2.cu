// Pairwise squared L2 and per-query candidate dots.
//
// Replaces the two Pallas kernels of repro/kernels/l2.py:
//
//   * pairwise_l2 (_l2_kernel): q [Q, n] x x [C, n] -> [Q, C],
//     max(|q|^2 - 2 q.x + |x|^2, 0) with fp32 accumulation.  It is the
//     exact scan (Dss) and so the ground truth of every recall number.
//     Bound by fp32 operations: 2n FLOPs per output against 4 bytes written
//     (n = 256: 512 FLOPs per output; the inputs are re-read from L2).
//     Design: a shared-memory tiled FMA product, as a plain SGEMM with both
//     operands k-contiguous.  A block owns a 64 (queries) x 128 (candidates)
//     output tile; 256 threads each keep a 4 x 8 register tile and walk n in
//     steps of 16, with the two operand tiles stored k-major in shared
//     memory so a thread reads its 4 + 8 operands as three 16-byte loads.
//     Four warps also sum the squares of the tile rows they see, so the row
//     norms come out of the same pass in a fixed order.  The epilogue clamps
//     at 0 and writes with 16-byte stores.  Full fp32 FMA, no TF32.  Offsets
//     are 64-bit: C * n passes 2^31 at a 2^23-row scan.
//
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
constexpr int kBM = 64;                    // queries per block
constexpr int kBN = 128;                   // candidates per block
constexpr int kBK = 16;                    // depth of one operand tile
constexpr int kTM = 4;                     // queries per thread
constexpr int kTN = 8;                     // candidates per thread (2 x 4)
constexpr int kL2Threads = (kBM / kTM) * (kBN / kTN);   // 256

// Load rows [row0, row0 + ROWS) x depth [k0, k0 + kBK) of a k-contiguous
// matrix into dst[k][row] (k-major), zero past the edges.
template <int ROWS>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          long long nrows, int n, long long row0,
                                          int k0, bool vec4,
                                          float (*dst)[ROWS + 4]) {
  constexpr int kQuads = ROWS * kBK / 4;   // 16-byte chunks in the tile
  for (int i = threadIdx.x; i < kQuads; i += kL2Threads) {
    const int r = i / (kBK / 4);
    const int kk = (i % (kBK / 4)) * 4;
    const long long gr = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gr < nrows) {
      const float* p = src + gr * n + k0 + kk;
      if (vec4 && k0 + kk + 4 <= n) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k0 + kk + j < n) v[j] = __ldg(p + j);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[kk + j][r] = v[j];
  }
}

__global__ void __launch_bounds__(kL2Threads)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int qn, long long cn, int n,
                   int vec4_in, int vec4_out) {
  __shared__ __align__(16) float as[kBK][kBM + 4];
  __shared__ __align__(16) float bs[kBK][kBN + 4];
  __shared__ float sq2[kBM];
  __shared__ float sx2[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);        // 0..15: candidate columns
  const int ty = tid / (kBN / kTN);        // 0..15: query rows
  const long long c0 = blockIdx.x * static_cast<long long>(kBN);
  const int q0 = blockIdx.y * kBM;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  float norm = 0.f;   // warps 0-1: |q|^2 of row tid; warps 2-5: |x|^2

  for (int k0 = 0; k0 < n; k0 += kBK) {
    load_tile<kBM>(q, qn, n, q0, k0, vec4_in, as);
    load_tile<kBN>(x, cn, n, c0, k0, vec4_in, bs);
    __syncthreads();
    if (tid < kBM) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) norm = fmaf(as[kk][tid], as[kk][tid], norm);
    } else if (tid < kBM + kBN) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk)
        norm = fmaf(bs[kk][tid - kBM], bs[kk][tid - kBM], norm);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 c4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4 + kBN / 2]);
      const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kBM) {
    sq2[tid] = norm;
  } else if (tid < kBM + kBN) {
    sx2[tid - kBM] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty * kTM + i;
    if (q0 + r >= qn) break;
    float* orow = out + static_cast<long long>(q0 + r) * cn;
    const float a2 = sq2[r];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cl = tx * 4 + h * (kBN / 2);    // column within the tile
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = fmaxf(a2 - 2.f * acc[i][h * 4 + j] + sx2[cl + j], 0.f);
      const long long c = c0 + cl;
      if (vec4_out && c + 4 <= cn) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < cn) orow[c + j] = v[j];
      }
    }
  }
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
  const long long gx = climber::ceil_div(cn, kBN);
  const long long gy = climber::ceil_div(qn, kBM);
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec4_in = (n % 4 == 0) && aligned16(q) && aligned16(x);
  const int vec4_out = (cn % 4 == 0) && aligned16(out);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  pairwise_l2_kernel<<<grid, kL2Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, x, out, qn, cn, n, vec4_in, vec4_out);
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
