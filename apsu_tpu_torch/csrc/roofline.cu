// Ceiling probes for sm_90a: the card's integer-multiply rates (K9) and its
// streaming rate and per-call floor (K10).
//
// K9, apsu_vpu_loop, replaces the TPU kernel tools/vpu_roofline.py:run_kernel
// (four Pallas bodies that chain REPS dependent u32 operations per element of
// a VMEM-resident block).  Each element runs, `outer` times over:
//   x = acc; then REPS times acc = step(acc, x)
// which is what `outer` chained calls of the TPU kernel compute.  The four
// steps are the products the other kernels use, on the card's own
// instructions rather than the TPU's 16-bit schoolbook:
//   mul32      acc * x + 1                       (one IMAD)
//   mul_wide   hi(acc * x) ^ lo(acc * x)         (a 32x32->64 product)
//   mont_mul   Montgomery product acc * x * 2^-32 mod p, one conditional
//              subtraction (the TPU reference's REDC, bit for bit, with the
//              carry folded into a second 32x32+64 product)
//   shoup_lazy acc * x - umulhi(acc, x) * p      (Harvey's lazy product with
//              x as both the constant and its companion, as the reference)
// All arithmetic is u32 with wraparound, so the result is any u32 and equals
// the plain int64 version bit for bit.  The kernel is bound by integer
// instruction issue and nothing else: each thread loads its elements once,
// keeps them in registers for all outer * REPS steps and writes them once.
// One element per thread would leave each warp waiting on IMAD latency, so a
// thread carries CHAINS independent elements (the (8,512,128) reference
// block is 131,072 threads, about 31 warps an SM).  The outer loop is not
// unrolled, so the SASS of its body is REPS * CHAINS steps plus the loop's
// own counter and branch: the tool counts instructions there.
//
// K10, apsu_add_one, replaces the TPU kernel tools/ntt4p_gl_ab.py:trivial
// (x + 1 over [B, L, 64, 128] u32 blocks, the per-call floor), and also
// serves the XLA stream arm of vpu_roofline.py.  It is bound by device-memory
// bytes: 16-byte vector loads and stores, four loads in flight a thread, each
// block one contiguous tile of 4 x 256 vectors (a grid-stride loop over a few
// blocks an SM streamed 6% slower than torch.add's kernel on the H100), and
// the last n % 4 elements by block 0.
//
// The entry points allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int REPS = 64;
constexpr int CHAINS = 4;
constexpr int LOOP_THREADS = 256;
constexpr int ADD_THREADS = 256;
constexpr int ADD_UNROLL = 4;   // 16-byte loads in flight a thread

enum Op { MUL32 = 0, MUL_WIDE = 1, MONT_MUL = 2, SHOUP_LAZY = 3 };

// a * b + c for u32 a, b and u64 c: one IMAD.WIDE.U32.  Written in PTX
// because from `(uint64_t)acc * x` in the loop below ptxas added a zero
// register to every product's high word (one more integer-ALU instruction a
// step in the H100 SASS), which the tool would then have measured.
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t acc, uint32_t x, uint32_t p,
                                         uint32_t pni) {
  if constexpr (OP == MUL32) {
    return acc * x + 1u;
  } else if constexpr (OP == MUL_WIDE) {
    const uint64_t w = mad_wide(acc, x, 0);
    return static_cast<uint32_t>(w >> 32) ^ static_cast<uint32_t>(w);
  } else if constexpr (OP == MONT_MUL) {
    const uint64_t w = mad_wide(acc, x, 0);
    const uint32_t m = static_cast<uint32_t>(w) * pni;
    // w + m * p = 0 mod 2^32, so its high word is hi(w) + hi(m * p) + (lo(w) != 0)
    // mod 2^32, the reference's t; the sum may pass 2^64, which drops only bits
    // above the high word
    const uint32_t t = static_cast<uint32_t>(mad_wide(m, p, w) >> 32);
    return t >= p ? t - p : t;
  } else {
    const uint32_t q = __umulhi(acc, x);
    return acc * x - q * p;
  }
}

template <int OP>
__global__ void __launch_bounds__(LOOP_THREADS)
vpu_loop_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                int64_t n, int64_t stride, uint32_t p, uint32_t pni, int outer) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    const int64_t i = t + k * stride;
    acc[k] = i < n ? x[i] : 0u;
  }
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
    uint32_t xs[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) xs[k] = acc[k];
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) acc[k] = step<OP>(acc[k], xs[k], p, pni);
    }
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    const int64_t i = t + k * stride;
    if (i < n) out[i] = acc[k];
  }
}

__global__ void __launch_bounds__(ADD_THREADS)
add_one_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n) {
  const int64_t n4 = n / 4;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * ADD_THREADS * ADD_UNROLL + threadIdx.x;
  uint4 v[ADD_UNROLL];
#pragma unroll
  for (int k = 0; k < ADD_UNROLL; ++k) {
    if (base + k * ADD_THREADS < n4) v[k] = x4[base + k * ADD_THREADS];
  }
#pragma unroll
  for (int k = 0; k < ADD_UNROLL; ++k) {
    if (base + k * ADD_THREADS < n4) {
      v[k].x += 1u;
      v[k].y += 1u;
      v[k].z += 1u;
      v[k].w += 1u;
      o4[base + k * ADD_THREADS] = v[k];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    out[4 * n4 + threadIdx.x] = x[4 * n4 + threadIdx.x] + 1u;
  }
}

}  // namespace

extern "C" int apsu_vpu_loop(const void* x, void* out, long long n, int op,
                             unsigned p, unsigned pni, int outer, void* stream) {
  const int64_t stride = (n + CHAINS - 1) / CHAINS;
  if (n > 0 && outer >= 0) {
    const unsigned blocks = static_cast<unsigned>((stride + LOOP_THREADS - 1) / LOOP_THREADS);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* xi = static_cast<const uint32_t*>(x);
    auto* o = static_cast<uint32_t*>(out);
    switch (op) {
      case MUL32:
        vpu_loop_kernel<MUL32><<<blocks, LOOP_THREADS, 0, s>>>(xi, o, n, stride, p, pni, outer);
        break;
      case MUL_WIDE:
        vpu_loop_kernel<MUL_WIDE><<<blocks, LOOP_THREADS, 0, s>>>(xi, o, n, stride, p, pni, outer);
        break;
      case MONT_MUL:
        vpu_loop_kernel<MONT_MUL><<<blocks, LOOP_THREADS, 0, s>>>(xi, o, n, stride, p, pni, outer);
        break;
      case SHOUP_LAZY:
        vpu_loop_kernel<SHOUP_LAZY><<<blocks, LOOP_THREADS, 0, s>>>(xi, o, n, stride, p, pni,
                                                                    outer);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apsu_add_one(const void* x, void* out, long long n, void* stream) {
  if (n > 0) {
    const int64_t tile = static_cast<int64_t>(ADD_THREADS) * ADD_UNROLL;
    const int64_t blocks = (n / 4 + tile - 1) / tile;
    add_one_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), ADD_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
