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
// thread carries CHAINS independent elements.  The outer loop is not
// unrolled, so the SASS of its body is REPS * CHAINS steps plus the loop's
// own counter and branch: the tool counts instructions there.
//
// What bounds each arm (chip_smoke.py --compare-roofline with
// csrc/compare/k9_probes.cu, both at f5d52af, on an H100 80GB HBM3 at 700 W;
// the readings are in PERF.md section 6): IMAD.WIDE.U32 and IMAD.HI.U32 each
// hold the FMA pipe about twice as long as IMAD, since a dependent chain of
// either takes about twice mul32's time.  So mul_wide (one IMAD.WIDE.U32, its
// LOP3 on the ALU pipe) cannot pass 1/2 of its bound, shoup_lazy (IMAD.HI
// and two IMAD) 3/4, mont_mul (an IMAD.WIDE.U32, an IMAD and an IMAD.HI) 3/5;
// each reads over 90% of that cap, as mul32 does of its own bound.
//
// The grid stays 256-thread blocks (the reference's (8,512,128) block is
// 131,072 threads, 512 blocks).  A warp issues one instruction for all its
// lanes, so the work of an SM sub-partition comes in warp-chains of 32
// elements: 2^19 elements are 16,384 of them, and 4 x 132 sub-partitions
// cannot hold fewer than 32 each on the busiest, which this grid gives
// (4 blocks of 2 warps x 4 chains).  No other block size or CHAINS spreads
// the tool's block more evenly (96.97% of the even share, whatever the plan).
//
// K10, apsu_add_one, replaces the TPU kernel tools/ntt4p_gl_ab.py:trivial
// (x + 1 over [B, L, 64, 128] u32 blocks, the per-call floor), and also
// serves the stream arm of vpu_roofline.py.  It is bound by device-memory
// bytes, and each 16-byte vector is read and written once: all a design can
// choose is how many loads a thread keeps in flight and how the blocks fill
// the card.  Timed in turns with the sources of csrc/compare/ at f5d52af (its
// chip_smoke.py --compare-roofline, on an H100 80GB HBM3 at 700 W; readings
// in PERF.md section 6), the fastest is one plain kernel at two shapes:
//   up to SMALL_VECS vectors, 256-thread blocks of 4 vectors a thread: a
//   launch of that size is about one wave, so every load is in flight at
//   once, and 128 x 1 blocks (k10_t128u1.cu) were slower at the ntt4p_gl_ab
//   rows of 3.7M, 7.3M and 8.4M elements;
//   above, 128-thread blocks of one vector a thread (the shape of
//   torch.add's kernel): 1 GiB is ~248 waves of small blocks and streams
//   about 1% faster than 256 x 4's 62.06 waves, the last of them 6% full.
//   SMALL_VECS (2^23 elements) is the largest row where 256 x 4 was the
//   faster (8.4M elements); the next, 14.7M, is the smallest where 128 x 1 was.
// Slower in the same turns: Hopper's ring of bulk asynchronous copies
// (k10_ring.cu: cp.async.bulk global -> shared on an mbarrier, x + 1 in
// shared memory, cp.async.bulk shared -> global, thread 0 issuing, two
// blocks an SM), by 4% at 1 GiB and 15-19% at the L2-resident rows (a pure
// stream has nothing to reuse, so one issuing thread and a block barrier a
// 16 KB stage likely cost more than they hide), though 1-3% faster at the
// 7.3M and 8.4M rows, too little for a third shape; 8 loads in flight a
// thread (k10_u8.cu), with or without streaming cache hints
// (k10_u8_hints.cu), by about 1% at 1 GiB.  The last n % 4 elements are
// block 0's.
//
// The entry points allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int REPS = 64;
constexpr int CHAINS = 4;
constexpr int LOOP_THREADS = 256;
constexpr int64_t SMALL_VECS = int64_t{1} << 21;   // 32 MiB of input

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

// The Montgomery step at its least on sm_90: IMAD.WIDE.U32 w = acc*x,
// IMAD m = lo(w)*pni, IMAD.HI.U32 t = hi(m*p + w) with w as its 64-bit
// addend (the carry of lo(m*p) + lo(w) included), all on the FMA pipe, and
// one VIADDMNMX.U32 min(t, t - p) on the ALU pipe, which is `t >= p ? t - p
// : t` for every u32 t and p < 2^32 (below p the difference wraps above t).
// Written as PTX's multiprecision pair mad.lo.cc / madc.hi: from mad.wide
// (m*p + w) or from C++ (csrc/compare/k9_mont_cxx.cu at f5d52af) ptxas took
// the high word by IMAD.WIDE.U32 and a 64-bit add on the ALU pipe, one more ALU
// instruction a step, and from a compare and select more again.
__device__ __forceinline__ uint32_t mont_step(uint32_t acc, uint32_t x, uint32_t p,
                                              uint32_t pni) {
  uint32_t r;
  asm("{\n\t"
      ".reg .u64 w;\n\t"
      ".reg .u32 lo, hi, m, t, u, z;\n\t"
      "mul.wide.u32 w, %1, %2;\n\t"
      "mov.b64 {lo, hi}, w;\n\t"
      "mul.lo.u32 m, lo, %4;\n\t"
      "mad.lo.cc.u32 z, m, %3, lo;\n\t"
      "madc.hi.u32 t, m, %3, hi;\n\t"
      "sub.u32 u, t, %3;\n\t"
      "min.u32 %0, t, u;\n\t"
      "}"
      : "=r"(r)
      : "r"(acc), "r"(x), "r"(p), "r"(pni));
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
    // w + m * p = 0 mod 2^32, so its high word is hi(w) + hi(m * p) + (lo(w) != 0)
    // mod 2^32, the reference's t; the sum may pass 2^64, which drops only bits
    // above the high word (madc.hi keeps the high word's own carry out of it)
    return mont_step(acc, x, p, pni);
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

__device__ __forceinline__ uint4 plus_one(uint4 v) {
  return make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
}

// x + 1 on n u32: block b's tile is THREADS * UNROLL vectors from vector
// b * THREADS * UNROLL, UNROLL 16-byte loads in flight a thread
template <int THREADS, int UNROLL>
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

template <int THREADS, int UNROLL>
void launch_add_one(const uint32_t* x, uint32_t* out, int64_t n, cudaStream_t s) {
  const int64_t tile = static_cast<int64_t>(THREADS) * UNROLL;
  const int64_t blocks = (n / 4 + tile - 1) / tile;
  add_one_kernel<THREADS, UNROLL>
      <<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), THREADS, 0, s>>>(x, out, n);
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  if (n / 4 > SMALL_VECS) {
    launch_add_one<128, 1>(xi, o, n, s);
  } else if (n > 0) {
    launch_add_one<256, 4>(xi, o, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
