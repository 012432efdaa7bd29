// Fused pivot distances + top-m prefix: the P4-> signature of paper Def. 5.
//
// Replaces the Pallas kernel repro/kernels/pivot_rank.py::pivot_rank
// (_pivot_rank_kernel): squared distances max(|x|^2 - 2 x.p + |p|^2, 0) from
// each [w] PAA row to the [r, w] pivots, then the ids of the m nearest,
// nearest first, ties to the lower pivot id.
//
// Bound by fp32 operations: 2*r*w FLOPs per row against 4w bytes read and 4m
// written (r=200, w=16: 6400 FLOPs per 104 bytes).  Design: the pivots and
// their norms sit in shared memory (12.8 KB at r=200, w=16); one thread owns
// one row, keeps the row in registers, and scans the pivot ids in ascending
// order, keeping a sorted (distance, id) list of length m in registers.  A
// candidate enters only on a strictly smaller distance, so a tie keeps the
// lower id, as jax.lax.top_k does.  The distances use fp32 FMA, not TF32:
// the signature is an integer result and has to match.
#include <math.h>

#include "climber_kernels.cuh"

namespace {

constexpr int kThreads = 128;

template <int W, int MAXM>
__global__ void pivot_rank_kernel(const float* __restrict__ paa,
                                  const float* __restrict__ pivots,
                                  int* __restrict__ out, long long b, int r,
                                  int m) {
  extern __shared__ float smem[];
  float* sp = smem;            // [r, W] pivots
  float* sp2 = smem + r * W;   // [r] pivot norms
  for (int i = threadIdx.x; i < r * W; i += blockDim.x) sp[i] = pivots[i];
  __syncthreads();
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < W; ++t) acc = fmaf(sp[j * W + t], sp[j * W + t], acc);
    sp2[j] = acc;
  }
  __syncthreads();

  const long long row = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (row >= b) return;
  float x[W];
  float x2 = 0.f;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    x[t] = __ldg(paa + row * W + t);
    x2 = fmaf(x[t], x[t], x2);
  }

  float bd[MAXM];
  int bi[MAXM];
#pragma unroll
  for (int t = 0; t < MAXM; ++t) {
    bd[t] = INFINITY;
    bi[t] = 0x7fffffff;
  }
  float worst = INFINITY;   // bd[m - 1], kept apart to avoid a dynamic index

  for (int j = 0; j < r; ++j) {
    float ab = 0.f;
#pragma unroll
    for (int t = 0; t < W; ++t) ab = fmaf(x[t], sp[j * W + t], ab);
    float d = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, ab)), sp2[j]);
    d = d > 0.f ? d : 0.f;
    if (d < worst) {
      // carry the candidate down the sorted list, ordered by (distance, id)
      float cd = d;
      int ci = j;
#pragma unroll
      for (int t = 0; t < MAXM; ++t) {
        if (t < m && (cd < bd[t] || (cd == bd[t] && ci < bi[t]))) {
          const float td = bd[t];
          const int ti = bi[t];
          bd[t] = cd;
          bi[t] = ci;
          cd = td;
          ci = ti;
        }
      }
#pragma unroll
      for (int t = 0; t < MAXM; ++t)
        if (t == m - 1) worst = bd[t];
    }
  }
#pragma unroll
  for (int t = 0; t < MAXM; ++t)
    if (t < m) out[row * m + t] = bi[t];
}

template <int W, int MAXM>
cudaError_t launch(const float* paa, const float* pivots, int* out,
                   long long b, int r, int m, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(r) * W + r);
  cudaError_t err = climber::allow_smem(pivot_rank_kernel<W, MAXM>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(climber::ceil_div(b, kThreads));
  pivot_rank_kernel<W, MAXM><<<blocks, kThreads, smem, stream>>>(
      paa, pivots, out, b, r, m);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_w(const float* paa, const float* pivots, int* out,
                     long long b, int r, int m, cudaStream_t stream) {
  if (m <= 16) return launch<W, 16>(paa, pivots, out, b, r, m, stream);
  return launch<W, 32>(paa, pivots, out, b, r, m, stream);
}

}  // namespace

// Supported widths: w in {4, 8, 16, 32, 64}, m <= 32, m <= r.
CLIMBER_API int climber_pivot_rank(const float* paa, const float* pivots,
                                   int* out, long long b, int w, int r, int m,
                                   void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if (m < 1 || m > 32 || m > r) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (w) {
    case 4: err = launch_w<4>(paa, pivots, out, b, r, m, s); break;
    case 8: err = launch_w<8>(paa, pivots, out, b, r, m, s); break;
    case 16: err = launch_w<16>(paa, pivots, out, b, r, m, s); break;
    case 32: err = launch_w<32>(paa, pivots, out, b, r, m, s); break;
    case 64: err = launch_w<64>(paa, pivots, out, b, r, m, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
