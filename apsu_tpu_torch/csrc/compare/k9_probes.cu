// K9 comparison probes (apsu_vpu_loop, op codes 4 and 5 only; 0-3 refused):
//   4 imad_wide_chain  a dependent IMAD.WIDE.U32 chain: a 64-bit state w per
//                      element, w = lo(w) * hi(w) each step; a round starts at
//                      (lo, hi) = (acc, x) and ends acc = lo(w) ^ hi(w)
//   5 imad_hi_chain    a dependent IMAD.HI.U32 chain: acc = hi(acc * x) + x
// in roofline.cu's vpu_loop grid (256-thread blocks, CHAINS = 4 elements a
// thread, REPS = 64 steps a round, the round loop not unrolled).  Their
// plain versions are chip_smoke.py:probe_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int REPS = 64, CHAINS = 4, LOOP_THREADS = 256;

__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

__device__ __forceinline__ uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

template <int OP>
__global__ void __launch_bounds__(LOOP_THREADS)
vpu_loop_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
                int64_t stride, int outer) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = t + k * stride < n ? x[t + k * stride] : 0u;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
    uint32_t xs[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) xs[k] = acc[k];
    if constexpr (OP == 4) {
      uint64_t w[CHAINS];
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) w[k] = (static_cast<uint64_t>(xs[k]) << 32) | acc[k];
#pragma unroll
      for (int r = 0; r < REPS; ++r) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
          w[k] = mad_wide(static_cast<uint32_t>(w[k]), static_cast<uint32_t>(w[k] >> 32), 0);
        }
      }
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) {
        acc[k] = static_cast<uint32_t>(w[k]) ^ static_cast<uint32_t>(w[k] >> 32);
      }
    } else {
#pragma unroll
      for (int r = 0; r < REPS; ++r) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) acc[k] = mad_hi(acc[k], xs[k], xs[k]);
      }
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  if (op != 4 && op != 5) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && outer >= 0) {
    if (op == 4) {
      vpu_loop_kernel<4><<<blocks, LOOP_THREADS, 0, s>>>(xi, o, n, stride, outer);
    } else {
      vpu_loop_kernel<5><<<blocks, LOOP_THREADS, 0, s>>>(xi, o, n, stride, outer);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
