// PAA mean-pool: [B, n] -> [B, w], the mean of seg = n/w contiguous samples.
//
// Replaces the Pallas kernel src/repro/kernels/paa_kernel.py:42 (paa,
// _paa_kernel).  Bound by HBM bytes: a row is 4n bytes read and 4w bytes
// written against n additions, so the card's memory rate sets the time.
//
// The order, kept bit for bit:
//   out[r, s] = (((0 + x[r, s*seg]) + x[r, s*seg + 1]) + ... + x[r, s*seg + seg-1]) / seg
// fp32 additions in increasing j and an IEEE division.  The signatures, and
// with them every plan, store layout and recall number downstream, depend
// on these bits; the port's first kernel summed in this order, so a tree or
// warp-shuffle sum would change every answer after it.
//
// What the first design lost: one thread per (row, segment) walked its own
// segment in device memory, so the lanes of a warp were seg * 4 bytes
// apart.  At seg = 128 one warp-wide 16-byte load touched 32 sectors 512 B
// apart and used half of each; the other half had to stay in L1 until the
// lane's next load, but the SM's warps spanned ~1 MB, four times L1, so
// sectors were fetched again: 2.2x the byte bound.  At seg = 16 a warp's
// 2 KB stayed in L1 and the kernel ran at 91% of its bound.
//
// This design keeps the order and changes only the memory side:
// - The input is B*w segments of seg floats back to back, so a tile of P
//   consecutive segments (kTileBytes, or one segment) is one contiguous
//   range.  Neighbouring lanes copy neighbouring 16-byte chunks of it into
//   shared memory with cp.async.cg: every sector is read whole, once.
// - Each block keeps a ring of kStages tiles and walks the tiles on a
//   persistent grid (as many blocks as fit on the card, 3 per SM): one tile
//   is in flight while the other is summed, 96 KB per SM.  A deeper ring of
//   smaller tiles kept more bytes in flight and was no faster (the
//   variants of tools/kernel_variants.py --kernel paa).
// - One thread per segment sums it out of shared memory from j = 0 upward.
//   Packed, its lanes would read seg * 4 bytes apart and conflict in banks
//   (4-way at seg = 16, 8-way at 128).  So, when seg / 4 is a power of two,
//   chunk j of segment p is stored at p * cps + (j ^ xp(p)), a permutation
//   inside each 128-byte line: the 8 lanes of a quarter-warp phase read 8
//   distinct bank groups, and a warp's copies still fill whole lines.
//   Padding segments to an odd chunk stride also removes the conflicts but
//   scatters the copies, and was slower than both.
// - The output is 1/seg of the input, yet its stores cost 12% of the time
//   at seg = 16 and 5% at seg = 128 (the `no_store` probe); the first
//   design paid the same at seg = 16.
// - seg % 4 != 0, or a base that is not 16-byte aligned, takes the same
//   design with 4-byte chunks (cp.async.ca), unswizzled.
// - Offsets into the input are 64-bit: the paper's shape is 4 GiB.
// - A segment must fit the ring: seg up to 29,056 samples; beyond that the
//   launch is refused.
#include "climber_kernels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;              // tiles in a block's ring
constexpr int kTileBytes = 32768;       // input bytes of a tile (one segment at least)
constexpr size_t kSmemLimit = 232448;   // what one block may use on Hopper

template <int V> struct Chunk;          // V bytes copied and read at a time
template <> struct Chunk<16> { using T = float4; };
template <> struct Chunk<4> { using T = float; };

template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float add_chunk(float acc, float4 v) {
  acc += v.x;
  acc += v.y;
  acc += v.z;
  acc += v.w;
  return acc;
}

__device__ __forceinline__ float add_chunk(float acc, float v) { return acc + v; }

// Segments of tile `tile` held in the input: P, or fewer in the last tile.
__device__ __forceinline__ int tile_segments(long long tile, int P, long long segs) {
  const long long left = segs - tile * P;
  return static_cast<int>(left < P ? (left > 0 ? left : 0) : P);
}

// Copy tile `tile` into ring slot `buf`: chunk g of the tile goes to
// g ^ ((g >> ws) & xm), its place in the swizzled layout (xm = 0: packed).
template <int V>
__device__ __forceinline__ void load_tile(typename Chunk<V>::T* buf,
                                          const typename Chunk<V>::T* x,
                                          long long tile, long long segs, int P,
                                          int cps, int ws, int xm) {
  const int total = tile_segments(tile, P, segs) * cps;
  const typename Chunk<V>::T* src = x + tile * P * cps;
  for (int g = threadIdx.x; g < total; g += kThreads)
    cp_async<V>(buf + (g ^ ((g >> ws) & xm)), src + g);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
paa_kernel(const typename Chunk<V>::T* __restrict__ x, float* __restrict__ out,
           long long segs, int seg, int P, long long tiles) {
  using T = typename Chunk<V>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int cps = seg / (V / 4);          // chunks per segment
  const int slot = P * cps;
  // The swizzle: chunk j of segment p at p * cps + (j ^ xp), xp =
  // (p >> xs) & xm, the same as chunk g = p * cps + j at g ^ ((g >> ws) & xm).
  // cps >= 8: xp = p & 7; cps < 8: the segments sharing a line differ in xp.
  const int lc = __ffs(cps) - 1;
  const int xm = V == 16 && (cps & (cps - 1)) == 0 ? (cps >= 8 ? 7 : cps - 1) : 0;
  const int xs = cps >= 8 ? 0 : 3 - lc;
  const int ws = lc + xs;
  const long long step = gridDim.x;
  long long tile = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_tile<V>(ring + s * slot, x, tile + s * step, segs, P, cps, ws, xm);
    cp_async_commit();
  }
  for (int i = 0; tile < tiles; ++i, tile += step) {
    // this thread's copies of tile i have landed; after the barrier every
    // thread's have, and every thread is done with slot (i - 1) % kStages
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_tile<V>(ring + ((i + kStages - 1) % kStages) * slot, x,
                 tile + (kStages - 1) * step, segs, P, cps, ws, xm);
    cp_async_commit();
    const T* buf = ring + (i % kStages) * slot;
    const int np = tile_segments(tile, P, segs);
    for (int p = threadIdx.x; p < np; p += kThreads) {
      const T* s = buf + p * cps;
      const int xp = (p >> xs) & xm;
      float acc = 0.f;
      for (int j = 0; j < cps; ++j) acc = add_chunk(acc, s[j ^ xp]);
      out[tile * P + p] = acc / static_cast<float>(seg);
    }
  }
  cp_async_wait<0>();
}

template <int V>
int launch(const float* x, float* out, long long segs, int seg, cudaStream_t stream) {
  using T = typename Chunk<V>::T;
  const int cps = seg / (V / 4);
  const int P = seg * 4 < kTileBytes ? kTileBytes / (seg * 4) : 1;
  const size_t smem = static_cast<size_t>(kStages) * P * cps * V;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = climber::ceil_div(segs, P);
  unsigned blocks = 0;
  cudaError_t err = climber::allow_smem(paa_kernel<V>, smem);
  if (err == cudaSuccess)
    err = climber::persistent_blocks(paa_kernel<V>, kThreads, smem, tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  paa_kernel<V><<<blocks, kThreads, smem, stream>>>(reinterpret_cast<const T*>(x),
                                                    out, segs, seg, P, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

CLIMBER_API int climber_paa(const float* x, float* out, long long b, int n,
                            int w, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if (w <= 0 || n <= 0 || n % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int seg = n / w;
  const long long segs = b * w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<16>(x, out, segs, seg, s);
  return launch<4>(x, out, segs, seg, s);
}

CLIMBER_API const char* climber_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
