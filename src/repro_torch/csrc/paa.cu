// PAA mean-pool: [B, n] -> [B, w], the mean of n/w contiguous samples.
//
// Replaces the Pallas kernel repro/kernels/paa_kernel.py::paa (_paa_kernel).
// Bound by HBM bytes: every input byte is read once and reduced n/w-fold,
// so the work is (4n + 4w) bytes per row against ~n additions.  Design: one
// thread per (row, segment) sums its segment with 16-byte loads; the threads
// of a warp cover 32 consecutive segments, i.e. a contiguous stretch of
// rows, so together they stream the input once.
#include "climber_kernels.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void paa_kernel(const float* __restrict__ x, float* __restrict__ out,
                           long long b, int n, int w, int vec4) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= b * w) return;
  const long long row = t / w;
  const int s = static_cast<int>(t - row * w);
  const int seg = n / w;
  const float* p = x + row * n + static_cast<long long>(s) * seg;
  float acc = 0.f;
  if (vec4) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (int j = 0; j < seg / 4; ++j) {
      const float4 v = __ldg(p4 + j);
      acc += v.x;
      acc += v.y;
      acc += v.z;
      acc += v.w;
    }
  } else {
    for (int j = 0; j < seg; ++j) acc += __ldg(p + j);
  }
  out[t] = acc / static_cast<float>(seg);
}

}  // namespace

CLIMBER_API int climber_paa(const float* x, float* out, long long b, int n,
                            int w, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if (w <= 0 || n % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = n / w;
  const int vec4 = (seg % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const long long total = b * w;
  const unsigned blocks =
      static_cast<unsigned>(climber::ceil_div(total, kThreads));
  paa_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, b, n, w, vec4);
  return static_cast<int>(cudaGetLastError());
}

CLIMBER_API const char* climber_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
