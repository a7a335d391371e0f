// Negacyclic NTT over RNS limbs, forward and inverse, for sm_90a.
//
// Replaces the TPU kernel apsu_tpu/ops/ntt4_pallas.py:ntt4_pallas (four-step
// n1=128 x n2=64 with int8 digit matmuls on the MXU) and computes the same
// function as apsu_tpu/core/ntt.py's staged transform: Cooley-Tukey with
// twiddles W[j] = psi^bitrev(j), bit-reversed output; the inverse runs the
// Gentleman-Sande stages in reverse order with W^{-1} and scales by N^{-1}.
//
// What bounds it: each residue must be read and written once (8 B), about
// 0.18 ms for the largest PS shape on an H100, and the integer work of
// log2 N butterfly stages is of the same order.  So the design keeps the
// stages in registers and touches shared memory and barriers as little as
// it can:
//   - a thread holds E = 2^LOG_E residues of a row and runs up to LOG_E
//     stages on them in registers (a "pass"); a row of N = 2^LOGN needs
//     ceil(LOGN / LOG_E) passes (N=8192, E=16: 4 + 4 + 4 + 1 stages) with
//     one exchange through shared memory between passes, instead of one
//     shared-memory round trip and barrier per stage;
//   - a pass holds bits [b0, b0 + LOG_E) of the residue index in the
//     thread's registers.  The forward transform starts with the highest
//     bits, so it loads straight from device memory with neighbouring
//     threads on neighbouring words; the inverse starts with the lowest
//     bits (16-byte loads of E contiguous residues) and stores from the
//     highest; the forward exchanges once more at its end so that its
//     stores too are coalesced words.  In both directions a short pass
//     (LOGN not a multiple of LOG_E) runs last, so that a block has a full
//     pass of work between its loads and its first barrier;
//   - the exchange address is XOR-swizzled (swz below) so that no pass's
//     layout has shared-memory bank conflicts;
//   - a stage's twiddles W[m + g] of one thread are contiguous and aligned,
//     read as 16- or 8-byte words; in the first passes every thread of a
//     warp reads the same ones (a broadcast).  Blocks are ordered limb-major,
//     so the blocks resident on an SM share one limb's tables in L1;
//   - __launch_bounds__ holds registers to 64 a thread at 1024 threads an
//     SM, so two blocks of a row of 8192 are resident together.
// Butterflies are Harvey lazy Shoup products on the native __umulhi: values
// stay in [0, 4p) between forward stages ([0, 2p) inverse) and are
// canonicalized once at the end, so outputs are bit-identical to the
// reference.  Any power-of-two N in [2, 8192] and any prime p < 2^30 (4p
// must fit 32 bits).
//
// Inputs must be canonical residues (< p) in 16-byte aligned rows.  The
// entry point allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LOG_E = 4;          // log2 of the residues a thread holds
constexpr int SM_THREADS = 1024;  // threads an SM must hold at once (__launch_bounds__)
constexpr int MIN_THREADS = 128;  // small rows share a block up to this many threads

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<I>{}) for I in [I0, I1), each I a compile-time constant
template <int I0, int I1, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I0 < I1) {
    f(Int<I0>{});
    static_for<I0 + 1, I1>(f);
  }
}

__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t w_sh, uint32_t p) {
  // x*w mod p in [0, 2p) for any 32-bit x: q = hi(x * w_sh), x*w - q*p
  return x * w - __umulhi(x, w_sh) * p;
}

// Exchange address of shared word a: a ^ f(a >> 5), with f linear over GF(2)
// and touching only the bank bits, so it permutes each 32-word line.  f was
// chosen so that in every pass layout of 8 or 16 residues a thread (for
// every N the kernel takes, rows of one block included) the 32 threads of a
// warp hit 32 distinct banks: the warp varies five address bits, and f makes
// their bank images independent.  Being linear, swz(t's bits ^ d's bits) =
// swz(t's bits) ^ swz(d's bits), the second a compile-time constant.
__host__ __device__ constexpr int swz(int a) {
  return a ^ ((a & 32 ? 5 : 0) ^ (a & 64 ? 10 : 0) ^ (a & 128 ? 25 : 0) ^ (a & 256 ? 20 : 0));
}

// The pass schedule of a row of N = 2^LOGN.  Passes are numbered in the
// forward's order (the inverse runs them from last to first); pass q holds
// index bits [b0(q), b0(q) + e) and runs the stages of its local bits
// [jlo(q), jhi(q)), highest first in the forward.  When e does not divide
// LOGN one pass runs only K0 < e stages, the last one run: at the bottom
// (pass P-1, bits [0, e)) in the forward, at the top (pass 0, holding bits
// [LOGN - e, LOGN)) in the inverse (kShortTop).
template <int LOGN, bool kShortTop>
struct Plan {
  static constexpr int e = LOG_E < LOGN ? LOG_E : LOGN;  // bits a thread holds
  static constexpr int E = 1 << e;
  static constexpr int N = 1 << LOGN;
  static constexpr int T_ROW = N / E;                    // threads per row
  static constexpr int P = (LOGN + e - 1) / e;           // passes
  static constexpr int K0 = LOGN - e * (P - 1);          // stages of the short pass
  static constexpr int RPB = T_ROW >= MIN_THREADS ? 1 : MIN_THREADS / T_ROW;
  static constexpr int THREADS = T_ROW * RPB;
  static constexpr int MIN_BLOCKS = SM_THREADS > THREADS ? SM_THREADS / THREADS : 1;
  static constexpr int SMEM_WORDS = P > 1 ? N * RPB : 0;
  __host__ __device__ static constexpr int b0(int q) {
    if (kShortTop) return q == 0 ? LOGN - e : LOGN - K0 - e * q;
    return q == P - 1 ? 0 : LOGN - e * (q + 1);
  }
  __host__ __device__ static constexpr int jlo(int q) { return kShortTop && q == 0 ? e - K0 : 0; }
  __host__ __device__ static constexpr int jhi(int q) { return !kShortTop && q == P - 1 ? K0 : e; }
};

// index of register d of thread t in a pass holding bits [B0, B0 + e)
template <int e, int B0>
__device__ __forceinline__ int elem(int t, int d) {
  return ((t >> B0) << (B0 + e)) | (d << B0) | (t & ((1 << B0) - 1));
}

// CNT contiguous words from an aligned address, in the widest loads that fit
template <int CNT>
__device__ __forceinline__ void load_words(uint32_t* v, const uint32_t* src) {
  if constexpr (CNT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CNT; c += 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + c));
      v[c] = q.x;
      v[c + 1] = q.y;
      v[c + 2] = q.z;
      v[c + 3] = q.w;
    }
  } else if constexpr (CNT == 2) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(src));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(src);
  }
}

template <int CNT>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* v) {
  if constexpr (CNT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CNT; c += 4)
      *reinterpret_cast<uint4*>(dst + c) = make_uint4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (CNT == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// a row's residues between device memory and registers in the layout of a
// pass holding bits [B0, B0 + e): a thread's E contiguous residues (B0 = 0)
// move as 16-byte words, single words coalesce across neighbouring threads
template <int e, int B0>
__device__ __forceinline__ void load_row(uint32_t* x, const uint32_t* row, int t) {
  if constexpr (B0 == 0) {
    load_words<(1 << e)>(x, row + (t << e));
  } else {
#pragma unroll
    for (int d = 0; d < (1 << e); ++d) x[d] = __ldg(row + elem<e, B0>(t, d));
  }
}

template <int e, int B0>
__device__ __forceinline__ void store_row(const uint32_t* x, uint32_t* row, int t) {
  if constexpr (B0 == 0) {
    store_words<(1 << e)>(row + (t << e), x);
  } else {
#pragma unroll
    for (int d = 0; d < (1 << e); ++d) row[elem<e, B0>(t, d)] = x[d];
  }
}

// registers in the layout of bits [BA, BA + e) -> shared memory -> bits
// [BB, BB + e); r is the thread's row within the block
template <int LOGN, int e, int BA, int BB>
__device__ __forceinline__ void exchange(uint32_t* x, uint32_t* smem, int r, int t) {
  constexpr int N = 1 << LOGN;
  const int wr = swz(r * N + elem<e, BA>(t, 0));
#pragma unroll
  for (int d = 0; d < (1 << e); ++d) smem[wr ^ swz(elem<e, BA>(0, d))] = x[d];
  __syncthreads();
  const int rd = swz(r * N + elem<e, BB>(t, 0));
#pragma unroll
  for (int d = 0; d < (1 << e); ++d) x[d] = smem[rd ^ swz(elem<e, BB>(0, d))];
}

// the stages of one pass on the thread's registers
template <int LOGN, int e, int B0, int JLO, int JHI, bool kInverse>
__device__ __forceinline__ void run_pass(uint32_t (&x)[1 << e], int t,
                                         const uint32_t* __restrict__ w,
                                         const uint32_t* __restrict__ wsh,
                                         uint32_t p) {
  const uint32_t two_p = p << 1;
  const int hi = t >> B0;
  static_for<0, JHI - JLO>([&](auto jj) {
    constexpr int j = kInverse ? JLO + decltype(jj)::value : JHI - 1 - decltype(jj)::value;
    constexpr int s = LOGN - 1 - (B0 + j);     // the reference's stage number
    constexpr int CNT = (1 << e) >> (j + 1);   // twiddles this thread needs
    // group g = hi << (e-1-j) | (d0 >> (j+1)); W[m + g] with m = 2^s
    const int base = (1 << s) + (hi << (e - 1 - j));
    uint32_t wv[CNT], sv[CNT];
    load_words<CNT>(wv, w + base);
    load_words<CNT>(sv, wsh + base);
#pragma unroll
    for (int k = 0; k < (1 << (e - 1)); ++k) {
      const int d0 = ((k >> j) << (j + 1)) | (k & ((1 << j) - 1));
      const int d1 = d0 | (1 << j);
      const int g = k >> j;
      if (!kInverse) {
        uint32_t u = x[d0];
        u = u >= two_p ? u - two_p : u;                     // [0, 2p)
        const uint32_t v = shoup_lazy(x[d1], wv[g], sv[g], p);
        x[d0] = u + v;                                      // [0, 4p)
        x[d1] = u + two_p - v;
      } else {
        const uint32_t u = x[d0];                           // [0, 2p)
        const uint32_t v = x[d1];
        uint32_t sum = u + v;
        sum = sum >= two_p ? sum - two_p : sum;
        x[d1] = shoup_lazy(u + two_p - v, wv[g], sv[g], p);
        x[d0] = sum;
      }
    }
  });
}

template <int LOGN, bool kInverse>
__global__ void __launch_bounds__(Plan<LOGN, kInverse>::THREADS,
                                  Plan<LOGN, kInverse>::MIN_BLOCKS)
ntt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
           const uint32_t* __restrict__ primes, const uint32_t* __restrict__ ninv,
           const uint32_t* __restrict__ ninv_sh, int L, int64_t batches,
           int64_t blocks_per_limb) {
  using PL = Plan<LOGN, kInverse>;
  constexpr int e = PL::e, E = PL::E, N = PL::N, P = PL::P;
  extern __shared__ uint32_t smem[];

  // limb-major blocks: the blocks on an SM at one time share a limb's tables
  const int l = static_cast<int>(blockIdx.x / blocks_per_limb);
  const int64_t group = blockIdx.x % blocks_per_limb;
  const int r = threadIdx.x / PL::T_ROW;
  const int t = threadIdx.x % PL::T_ROW;
  const int64_t batch = group * PL::RPB + r;
  const bool active = batch < batches;   // inactive threads still meet the barriers
  const int64_t row = batch * L + l;
  const uint32_t p = primes[l];
  const uint32_t* w = tw + static_cast<int64_t>(l) * N;
  const uint32_t* wsh = tw_sh + static_cast<int64_t>(l) * N;

  uint32_t x[E];
  if (active) {
    load_row<e, PL::b0(kInverse ? P - 1 : 0)>(x, in + row * N, t);
  } else {
#pragma unroll
    for (int d = 0; d < E; ++d) x[d] = 0;
  }

  static_for<0, P>([&](auto step) {
    constexpr int S = decltype(step)::value;
    constexpr int q = kInverse ? P - 1 - S : S;
    if constexpr (S > 0) {
      if constexpr (S > 1) __syncthreads();   // the last exchange's reads are done
      exchange<LOGN, e, PL::b0(kInverse ? q + 1 : q - 1), PL::b0(q)>(x, smem, r, t);
    }
    run_pass<LOGN, e, PL::b0(q), PL::jlo(q), PL::jhi(q), kInverse>(x, t, w, wsh, p);
  });

  const uint32_t two_p = p << 1;
  if (!kInverse) {
#pragma unroll
    for (int d = 0; d < E; ++d) {
      uint32_t v = x[d];
      v = v >= two_p ? v - two_p : v;
      x[d] = v >= p ? v - p : v;
    }
  } else {
    const uint32_t c = ninv[l];
    const uint32_t c_sh = ninv_sh[l];
#pragma unroll
    for (int d = 0; d < E; ++d) {
      const uint32_t v = shoup_lazy(x[d], c, c_sh, p);
      x[d] = v >= p ? v - p : v;
    }
  }
  // the forward exchanges once more, into its first pass's layout, so that
  // a warp's stores are coalesced words as the inverse's are
  constexpr bool kStaged = !kInverse && P > 1;
  constexpr int B_LAST = PL::b0(kInverse || kStaged ? 0 : P - 1);
  if constexpr (kStaged) {
    __syncthreads();
    exchange<LOGN, e, PL::b0(P - 1), B_LAST>(x, smem, r, t);
  }
  if (active) store_row<e, B_LAST>(x, out + row * N, t);
}

template <int LOGN, bool kInverse>
cudaError_t launch(const uint32_t* x, uint32_t* y, const uint32_t* w, const uint32_t* wsh,
                   const uint32_t* ps, const uint32_t* ni, const uint32_t* nish,
                   int64_t rows, int L, cudaStream_t st) {
  using PL = Plan<LOGN, kInverse>;
  const int64_t batches = rows / L;
  const int64_t blocks_per_limb = (batches + PL::RPB - 1) / PL::RPB;
  const int64_t blocks = blocks_per_limb * L;
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidConfiguration;
  ntt_kernel<LOGN, kInverse>
      <<<static_cast<unsigned>(blocks), PL::THREADS, PL::SMEM_WORDS * sizeof(uint32_t), st>>>(
          x, y, w, wsh, ps, ni, nish, L, batches, blocks_per_limb);
  return cudaSuccess;
}

template <bool kInverse>
cudaError_t dispatch(int logn, const uint32_t* x, uint32_t* y, const uint32_t* w,
                     const uint32_t* wsh, const uint32_t* ps, const uint32_t* ni,
                     const uint32_t* nish, int64_t rows, int L, cudaStream_t st) {
  switch (logn) {
#define APSU_NTT_CASE(K) \
  case K:                \
    return launch<K, kInverse>(x, y, w, wsh, ps, ni, nish, rows, L, st);
    APSU_NTT_CASE(1) APSU_NTT_CASE(2) APSU_NTT_CASE(3) APSU_NTT_CASE(4)
    APSU_NTT_CASE(5) APSU_NTT_CASE(6) APSU_NTT_CASE(7) APSU_NTT_CASE(8)
    APSU_NTT_CASE(9) APSU_NTT_CASE(10) APSU_NTT_CASE(11) APSU_NTT_CASE(12)
    APSU_NTT_CASE(13)
#undef APSU_NTT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int apsu_ntt(const void* in, void* out, const void* tw,
                        const void* tw_sh, const void* primes, const void* ninv,
                        const void* ninv_sh, long long rows, int L, int logn,
                        int inverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  const auto* w = static_cast<const uint32_t*>(tw);
  const auto* wsh = static_cast<const uint32_t*>(tw_sh);
  const auto* ps = static_cast<const uint32_t*>(primes);
  const auto* ni = static_cast<const uint32_t*>(ninv);
  const auto* nish = static_cast<const uint32_t*>(ninv_sh);
  if (rows <= 0 || L <= 0 || rows % L != 0) {
    return rows == 0 ? static_cast<int>(cudaGetLastError())
                     : static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      inverse ? dispatch<true>(logn, x, y, w, wsh, ps, ni, nish, rows, L, st)
              : dispatch<false>(logn, x, y, w, wsh, ps, ni, nish, rows, L, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
