// Paterson-Stockmeyer inner sums for sm_90a:
//   out[r, k, c] = sum_{i=1..ph-1} low[r / C, i-1, c] (.)_mont cache[r, k*ph + i]
// per limb l and lane n, c in {0, 1} (the two ciphertext components).
//
// Replaces the TPU kernel apsu_tpu/ops/polyeval.py:eval_ps_inner_pallas3
// (row-resident grid with 14-bit operand splits on the 32-bit VPU).  Here
// one thread owns one output lane (r, k, l, n), n fastest so that every load
// coalesces.  The thread keeps two u64 accumulators (one per component),
// streams its ph-1 cache planes, and ends with one 64-bit Montgomery
// reduction per accumulator and a final reduction to [0, p).  It takes any
// prime < 2^30 and any ph: a product is < 2^60, and every FOLD_EVERY
// products the high word of each sum is reduced mod p (as csrc/eval_dot.cu
// does), leaving it below p * 2^32 < 2^62 before the next FOLD_EVERY
// (< 2^63) arrive, so no sum wraps.  The result is the canonical
// R^{-1} * sum a*b mod p, which the reference computes too (it adds
// canonical Montgomery partial sums), so outputs are bit-identical.
//
// The kernel is bound by device-memory bytes: the cache streams from device
// memory exactly once (each plane feeds both components), the low powers are
// re-read per segment from L2, and the output is written once.  The cache is
// addressed through its row stride, so a strided view of a larger cache
// (the evaluator's cache_r[:, :nseg*ph]) is read in place, never copied.
//
// The entry point allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FOLD_EVERY = 8;

__device__ __forceinline__ uint64_t fold(uint64_t s, uint32_t p) {
  // s mod p * 2^32 on the high word: the value mod p is unchanged
  const uint32_t hi = static_cast<uint32_t>(s >> 32) % p;
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(s);
}

__device__ __forceinline__ uint32_t redc64(uint64_t s, uint32_t p,
                                           uint32_t p_neg_inv) {
  // (s + m*p) / 2^32 with m = lo(s) * (-p^{-1}) mod 2^32, split so that no
  // intermediate exceeds 64 bits for any s < 2^64
  const uint32_t lo = static_cast<uint32_t>(s);
  const uint32_t m = lo * p_neg_inv;
  const uint64_t t =
      (s >> 32) + ((static_cast<uint64_t>(lo) + static_cast<uint64_t>(m) * p) >> 32);
  return static_cast<uint32_t>(t % p);
}

__global__ void ps_inner_kernel(const uint32_t* __restrict__ low,
                                const uint32_t* __restrict__ cache,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ primes,
                                const uint32_t* __restrict__ p_neg_inv,
                                int64_t cache_row_stride, int C, int nseg,
                                int ph, int L, int N, int64_t total) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % N);
  int64_t rest = idx / N;
  const int l = static_cast<int>(rest % L);
  rest /= L;
  const int k = static_cast<int>(rest % nseg);
  const int64_t r = rest / nseg;
  const int64_t b = r / C;
  const int64_t LN = static_cast<int64_t>(L) * N;
  const int64_t lane = static_cast<int64_t>(l) * N + n;

  const uint32_t* cp = cache + r * cache_row_stride + static_cast<int64_t>(k) * ph * LN + lane;
  const uint32_t* lp = low + b * (ph - 1) * 2 * LN + lane;
  const uint32_t p = primes[l];
  uint64_t s0 = 0, s1 = 0;
  for (int i = 1; i < ph; ++i) {
    const uint64_t c = cp[i * LN];
    const uint32_t* li = lp + static_cast<int64_t>(i - 1) * 2 * LN;
    s0 += c * li[0];
    s1 += c * li[LN];
    if (i % FOLD_EVERY == 0) {
      s0 = fold(s0, p);
      s1 = fold(s1, p);
    }
  }
  const uint32_t pni = p_neg_inv[l];
  uint32_t* o = out + ((r * nseg + k) * 2) * LN + lane;
  o[0] = redc64(s0, p, pni);
  o[LN] = redc64(s1, p, pni);
}

}  // namespace

extern "C" int apsu_ps_inner(const void* low, const void* cache, void* out,
                             const void* primes, const void* p_neg_inv,
                             long long cache_row_stride, int R, int C, int nseg,
                             int ph, int L, int N, void* stream) {
  const int64_t total = static_cast<int64_t>(R) * nseg * L * N;
  const int threads = 256;
  if (total > 0) {
    const int64_t blocks = (total + threads - 1) / threads;
    ps_inner_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(low), static_cast<const uint32_t*>(cache),
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(primes),
        static_cast<const uint32_t*>(p_neg_inv), cache_row_stride, C, nseg, ph,
        L, N, total);
  }
  return static_cast<int>(cudaGetLastError());
}
