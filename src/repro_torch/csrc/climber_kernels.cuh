// Shared helpers of the CLIMBER Hopper kernels (sm_90a).
//
// Every launcher has a plain C interface (bound from Python with ctypes),
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch surfaces in the wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CLIMBER_API extern "C" __attribute__((visibility("default")))

namespace climber {

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// Raise a kernel's dynamic shared-memory ceiling when it needs more than
// the 48 KB a launch gets by default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The number of SMs of the current device.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of a persistent grid: as many as can be resident on the card at
// once, and no more than `want`.
template <typename Kernel>
inline cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                                     long long want, unsigned* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(want < most ? want : most);
  return cudaSuccess;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace climber

// l2.cu: out[Q, C] = max(|q|^2 - 2 q.x + |x|^2, 0) for q [Q, n], x [C, n].
CLIMBER_API int climber_pairwise_l2(const float* q, const float* x, float* out,
                                    int qn, long long cn, int n, void* stream);
// l2.cu: out[Q, C] = rows[q, c, :] . q[q, :] for q [Q, n], rows [Q, C, n].
CLIMBER_API int climber_qdots(const float* q, const float* rows, float* out,
                              int qn, long long cn, int n, void* stream);
