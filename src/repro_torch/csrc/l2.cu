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
//     Bound by HBM bytes: 2 FLOPs per 4 bytes of rows.  Design: grid
//     (candidate tiles of 64, Q); the block keeps its query row in shared
//     memory and each warp reduces one candidate row at a time, lane j
//     taking the 16-byte chunks j, j + 32, ... and the warp summing by a
//     butterfly.  The summation order depends on n alone, so a row's dot
//     does not depend on the batch it rides in.
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
constexpr int kQdWarps = kQdThreads / 32;
constexpr int kQdRows = 64;                // candidate rows per block

__global__ void __launch_bounds__(kQdThreads)
qdots_kernel(const float* __restrict__ q, const float* __restrict__ rows,
             float* __restrict__ out, long long cn, int n, int vec4) {
  extern __shared__ float4 sq4[];          // the query row, n floats
  float* sq = reinterpret_cast<float*>(sq4);
  const long long qi = blockIdx.y;
  const float* qrow = q + qi * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sq[i] = __ldg(qrow + i);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long tile0 = blockIdx.x * static_cast<long long>(kQdRows);
  for (int r = warp; r < kQdRows; r += kQdWarps) {
    const long long c = tile0 + r;
    if (c >= cn) break;
    const float* p = rows + (qi * cn + c) * n;
    float acc = 0.f;
    if (vec4) {
      const float4* p4 = reinterpret_cast<const float4*>(p);
      for (int j = lane; j < n / 4; j += 32) {
        const float4 v = __ldg(p4 + j);
        const float4 w = sq4[j];
        acc = fmaf(v.x, w.x, acc);
        acc = fmaf(v.y, w.y, acc);
        acc = fmaf(v.z, w.z, acc);
        acc = fmaf(v.w, w.w, acc);
      }
    } else {
      for (int j = lane; j < n; j += 32) acc = fmaf(__ldg(p + j), sq[j], acc);
    }
    acc = climber::warp_sum(acc);
    if (lane == 0) out[qi * cn + c] = acc;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  const long long gx = climber::ceil_div(cn, kQdRows);
  if (gx > 0x7fffffffLL || qn > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(climber::ceil_div(n, 4)) * 16;
  cudaError_t err = climber::allow_smem(qdots_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec4 = (n % 4 == 0) && aligned16(q) && aligned16(rows);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(qn));
  qdots_kernel<<<grid, kQdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, rows, out, cn, n, vec4);
  return static_cast<int>(cudaGetLastError());
}
