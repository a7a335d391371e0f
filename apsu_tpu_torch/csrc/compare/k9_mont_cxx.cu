// K9 comparison: mont_mul (apsu_vpu_loop, op code 2 only; the other arms
// refused) with its step written in C++,
//   w = acc * (u64)x; m = lo(w) * pni; t = hi(m * (u64)p + w); min(t, t - p)
// where roofline.cu writes it as PTX's mad.lo.cc / madc.hi pair; the grid
// is roofline.cu's.  vpu_roofline.sass_per_step reads what ptxas made of it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int REPS = 64, CHAINS = 4, LOOP_THREADS = 256;

__device__ __forceinline__ uint32_t mont_step(uint32_t acc, uint32_t x, uint32_t p,
                                              uint32_t pni) {
  const uint64_t w = static_cast<uint64_t>(acc) * x;
  const uint32_t m = static_cast<uint32_t>(w) * pni;
  const uint32_t t = static_cast<uint32_t>((static_cast<uint64_t>(m) * p + w) >> 32);
  return min(t, t - p);
}

// a template on the op code, as roofline.cu's, so that sass_per_step finds it
template <int OP>
__global__ void __launch_bounds__(LOOP_THREADS)
vpu_loop_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
                int64_t stride, uint32_t p, uint32_t pni, int outer) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = t + k * stride < n ? x[t + k * stride] : 0u;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
    uint32_t xs[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) xs[k] = acc[k];
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) acc[k] = mont_step(acc[k], xs[k], p, pni);
    }
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    if (t + k * stride < n) out[t + k * stride] = acc[k];
  }
}

}  // namespace

extern "C" int apsu_vpu_loop(const void* x, void* out, long long n, int op, unsigned p,
                             unsigned pni, int outer, void* stream) {
  const int64_t stride = (n + CHAINS - 1) / CHAINS;
  const unsigned blocks = static_cast<unsigned>((stride + LOOP_THREADS - 1) / LOOP_THREADS);
  if (op != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && outer >= 0) {
    vpu_loop_kernel<2><<<blocks, LOOP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, stride, p, pni, outer);
  }
  return static_cast<int>(cudaGetLastError());
}
