// K10 comparison (apsu_add_one only): 128-thread blocks of one 16-byte load a thread at every size
// (roofline.cu takes this shape only above SMALL_VECS vectors)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128, UNROLL = 1;

__device__ __forceinline__ uint4 plus_one(uint4 v) {
  return make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
}

// block b's tile is THREADS * UNROLL vectors from vector b * THREADS * UNROLL
__global__ void __launch_bounds__(THREADS)
add_one_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS * UNROLL + threadIdx.x;
  uint4 v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    if (base + k * THREADS < n4) v[k] = x4[base + k * THREADS];
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    if (base + k * THREADS < n4) o4[base + k * THREADS] = plus_one(v[k]);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    out[4 * n4 + threadIdx.x] = x[4 * n4 + threadIdx.x] + 1u;
  }
}

}  // namespace

extern "C" int apsu_add_one(const void* x, void* out, long long n, void* stream) {
  if (n > 0) {
    const int64_t tile = static_cast<int64_t>(THREADS) * UNROLL;
    const int64_t blocks = (n / 4 + tile - 1) / tile;
    add_one_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
