// Matching-polynomial dot product for sm_90a:
//   out[b, c, comp] = sum_{j=1..D} powers[b, j-1, comp] (.)_mont cache[b, c, j]
// per limb l and lane n, comp in {0, 1} (the two ciphertext components).
//
// Replaces the TPU kernel apsu_tpu/ops/polyeval.py:eval_dot_pallas (a
// reduction grid over 8-plane chunks with 14-bit operand splits on the
// 32-bit VPU, cache-blocked so one power chunk serves a block of caches).
// Here one thread owns one output lane (b, l, n) for a block of up to
// CACHE_BLOCK caches, n fastest so that every load coalesces.  Per plane j it
// loads the two power residues once and reuses them across the caches of its
// block (the point of the TPU kernel's cache blocking), and keeps two u64
// accumulators per cache.  Plane 0 of the cache (the constant coefficient)
// and its zero-padded tail are never read: the power tensor comes unpadded,
// [B, D, 2, L, N], and plane j of the cache pairs with power j-1.
//
// Operand bound: every prime < 2^30, so a product is < 2^60.  Every
// FOLD_EVERY products the high word of each sum is reduced mod p, which
// brings the sum below p * 2^32 < 2^62; FOLD_EVERY more products add less
// than 2^63, so no sum ever wraps.  One last fold and one 64-bit Montgomery
// reduction give the canonical sum(a*b) * R^{-1} mod p, which is what the
// reference computes too (it reduces every 8 planes and adds the canonical
// partial sums), so outputs are bit-identical.
//
// The kernel is bound by device-memory bytes: each cache plane it needs
// streams from device memory once, each power plane is read once per cache
// block (from L2 after the first block), and the output is written once.
//
// The entry point allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CACHE_BLOCK = 4;
constexpr int FOLD_EVERY = 8;

__device__ __forceinline__ uint64_t fold(uint64_t s, uint32_t p) {
  // s mod p * 2^32 on the high word: the value mod p is unchanged
  const uint32_t hi = static_cast<uint32_t>(s >> 32) % p;
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(s);
}

__device__ __forceinline__ uint32_t redc(uint64_t s, uint32_t p, uint32_t p_neg_inv) {
  // s < p * 2^32: t = (s + m*p) / 2^32 < 2p, no intermediate above 2^63
  const uint32_t m = static_cast<uint32_t>(s) * p_neg_inv;
  const uint32_t t = static_cast<uint32_t>((s + static_cast<uint64_t>(m) * p) >> 32);
  return t >= p ? t - p : t;
}

__global__ void eval_dot_kernel(const uint32_t* __restrict__ powers,
                                const uint32_t* __restrict__ cache,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ primes,
                                const uint32_t* __restrict__ p_neg_inv,
                                int C, int D, int Dp, int L, int N,
                                int64_t lanes) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= lanes) return;
  const int n = static_cast<int>(idx % N);
  const int64_t rest = idx / N;
  const int l = static_cast<int>(rest % L);
  const int64_t b = rest / L;
  const int c0 = blockIdx.y * CACHE_BLOCK;
  const int nc = min(CACHE_BLOCK, C - c0);
  const int64_t LN = static_cast<int64_t>(L) * N;
  const int64_t lane = static_cast<int64_t>(l) * N + n;
  const uint32_t p = primes[l];

  const uint32_t* pw = powers + b * D * 2 * LN + lane;            // power 0, comp 0
  const uint32_t* cp = cache + (b * C + c0) * Dp * LN + LN + lane;  // cache c0, plane 1
  const int64_t cache_stride = static_cast<int64_t>(Dp) * LN;

  uint64_t s0[CACHE_BLOCK], s1[CACHE_BLOCK];
#pragma unroll
  for (int c = 0; c < CACHE_BLOCK; ++c) s0[c] = s1[c] = 0;

  for (int j = 0; j < D; ++j) {
    const uint64_t a0 = pw[(2 * j) * LN];
    const uint64_t a1 = pw[(2 * j + 1) * LN];
#pragma unroll
    for (int c = 0; c < CACHE_BLOCK; ++c) {
      if (c < nc) {
        const uint64_t x = cp[c * cache_stride + j * LN];
        s0[c] += a0 * x;
        s1[c] += a1 * x;
      }
    }
    if ((j + 1) % FOLD_EVERY == 0) {
#pragma unroll
      for (int c = 0; c < CACHE_BLOCK; ++c) {
        s0[c] = fold(s0[c], p);
        s1[c] = fold(s1[c], p);
      }
    }
  }

  const uint32_t pni = p_neg_inv[l];
  uint32_t* o = out + (b * C + c0) * 2 * LN + lane;
#pragma unroll
  for (int c = 0; c < CACHE_BLOCK; ++c) {
    if (c < nc) {
      o[(2 * c) * LN] = redc(fold(s0[c], p), p, pni);
      o[(2 * c + 1) * LN] = redc(fold(s1[c], p), p, pni);
    }
  }
}

}  // namespace

extern "C" int apsu_eval_dot(const void* powers, const void* cache, void* out,
                             const void* primes, const void* p_neg_inv, int B,
                             int C, int D, int Dp, int L, int N, void* stream) {
  const int64_t lanes = static_cast<int64_t>(B) * L * N;
  const int threads = 256;
  if (lanes > 0 && C > 0) {
    const dim3 grid(static_cast<unsigned>((lanes + threads - 1) / threads),
                    static_cast<unsigned>((C + CACHE_BLOCK - 1) / CACHE_BLOCK));
    eval_dot_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(powers), static_cast<const uint32_t*>(cache),
        static_cast<uint32_t*>(out), static_cast<const uint32_t*>(primes),
        static_cast<const uint32_t*>(p_neg_inv), C, D, Dp, L, N, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
