// The receiver's mask draw, for sm_90a: AES-256-CTR keystream cut into
// little-endian 64-bit words, each reduced mod span and moved up by lo.
//
// Replaces no Pallas kernel: the reference draws each query's mask on the
// host (apsu_tpu/api/parties.py, Receiver._prepare: CsRng.integers, an
// OpenSSL AES-CTR stream and a numpy modulo).  This kernel makes the same
// words from the same key and counter, so out[i] equals that draw bit for
// bit: out[i] = (le_u64(keystream[offset + 8i : offset + 8i + 8]) mod span)
// + lo, where the keystream is AES-256 of the 128-bit big-endian counters
// ctr, ctr + 1, ... (cryptography's modes.CTR, which carries across every
// 32- and 64-bit boundary) and offset (0-15) skips bytes of the first block.
//
// What bounds it: its integer operations.  A 1M-2048-cmp mask is 307,200
// words, 153,600 AES blocks (14 rounds of 16 table lookups each) and 1.2 MB
// written; its ~1,300 integer instructions a block take ~12 us at the card's
// INT32 rate, its lookups ~5 us and its bytes well under 1 us.  One thread
// makes one block, two words.
// The round table Te0 (Te1-Te3 are its rotations, the S-box its byte 1) sits
// in shared memory once for each of the 32 banks, entry x of bank b at
// x * 32 + b, so a warp's 32 lookups at 32 unrelated indices meet no bank
// conflict.  The round keys are expanded on the host (ops/ctr_mod.py) and
// passed by value: every round reads them through the constant cache.  A
// step of a block writes its keystream to shared memory, where the words are
// cut at any byte offset, then reduced by a precomputed reciprocal
// (mu = floor((2^64 - 1) / span): the quotient's estimate is low by at most
// one, so one correction).
//
// Given a host buffer (pinned, so mapped into the card's address space
// under unified addressing), the kernel also stores each word there: the
// host copy of the receiver's mask comes with the draw, its 1.2 MB over
// PCIe, and no copy needs queuing.  The entry point then records the event
// done after the kernel, for the host to wait on before it reads the copy.
//
// The entry point allocates nothing and launches on the given stream of the
// given device (made current for the call, then restored).  It returns a
// CUDA error, 0 for a launch, or -1 for a launch captured into a CUDA graph
// (a draw with a host copy cannot be captured).  One call does all of this
// because each call from Python into torch or the CUDA runtime costs
// microseconds on the query's host path.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;            // AES blocks in a step of a block
constexpr int WORDS = 2 * THREADS;      // words in a step
constexpr int BANKS = 32;
constexpr long long MAX_GRID = 1024;    // further steps loop inside the blocks

struct RoundKeys {
  uint32_t w[60];   // AES-256's 15 round keys, big-endian columns
};

__device__ __forceinline__ uint32_t ror(uint32_t x, int s) { return __funnelshift_r(x, x, s); }

// AES-256 of the counter block (hi, lo); its 16 bytes as 4 little-endian words
__device__ __forceinline__ uint4 aes_block(const uint32_t* __restrict__ T, int bank,
                                           const RoundKeys& rk, uint64_t hi, uint64_t lo) {
#define TE(x) T[((x) << 5) | bank]
  uint32_t s0 = static_cast<uint32_t>(hi >> 32) ^ rk.w[0];
  uint32_t s1 = static_cast<uint32_t>(hi) ^ rk.w[1];
  uint32_t s2 = static_cast<uint32_t>(lo >> 32) ^ rk.w[2];
  uint32_t s3 = static_cast<uint32_t>(lo) ^ rk.w[3];
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    const uint32_t t0 = TE(s0 >> 24) ^ ror(TE((s1 >> 16) & 0xff), 8) ^
                        ror(TE((s2 >> 8) & 0xff), 16) ^ ror(TE(s3 & 0xff), 24) ^ rk.w[4 * r];
    const uint32_t t1 = TE(s1 >> 24) ^ ror(TE((s2 >> 16) & 0xff), 8) ^
                        ror(TE((s3 >> 8) & 0xff), 16) ^ ror(TE(s0 & 0xff), 24) ^ rk.w[4 * r + 1];
    const uint32_t t2 = TE(s2 >> 24) ^ ror(TE((s3 >> 16) & 0xff), 8) ^
                        ror(TE((s0 >> 8) & 0xff), 16) ^ ror(TE(s1 & 0xff), 24) ^ rk.w[4 * r + 2];
    const uint32_t t3 = TE(s3 >> 24) ^ ror(TE((s0 >> 16) & 0xff), 8) ^
                        ror(TE((s1 >> 8) & 0xff), 16) ^ ror(TE(s2 & 0xff), 24) ^ rk.w[4 * r + 3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  // the last round: SubBytes (S[x] is byte 1 of Te0[x]), ShiftRows, the key
#define SB(x) ((TE(x) >> 8) & 0xff)
  const uint32_t o0 = (SB(s0 >> 24) << 24) | (SB((s1 >> 16) & 0xff) << 16) |
                      (SB((s2 >> 8) & 0xff) << 8) | SB(s3 & 0xff);
  const uint32_t o1 = (SB(s1 >> 24) << 24) | (SB((s2 >> 16) & 0xff) << 16) |
                      (SB((s3 >> 8) & 0xff) << 8) | SB(s0 & 0xff);
  const uint32_t o2 = (SB(s2 >> 24) << 24) | (SB((s3 >> 16) & 0xff) << 16) |
                      (SB((s0 >> 8) & 0xff) << 8) | SB(s1 & 0xff);
  const uint32_t o3 = (SB(s3 >> 24) << 24) | (SB((s0 >> 16) & 0xff) << 16) |
                      (SB((s1 >> 8) & 0xff) << 8) | SB(s2 & 0xff);
#undef SB
#undef TE
  // a column's big-endian bytes are the keystream's next four bytes
  return make_uint4(__byte_perm(o0 ^ rk.w[56], 0, 0x0123), __byte_perm(o1 ^ rk.w[57], 0, 0x0123),
                    __byte_perm(o2 ^ rk.w[58], 0, 0x0123), __byte_perm(o3 ^ rk.w[59], 0, 0x0123));
}

__global__ void __launch_bounds__(THREADS)
ctr_mod_kernel(const uint32_t* __restrict__ te0, const RoundKeys rk, uint64_t ctr_hi,
               uint64_t ctr_lo, int offset, uint32_t lo, uint32_t span, uint64_t mu,
               int32_t* __restrict__ out, int32_t* __restrict__ host, long long n) {
  __shared__ uint32_t T[256 * BANKS];
  __shared__ uint4 ks[THREADS + 1];   // a step's keystream, and the block after it
  for (int i = threadIdx.x; i < 256 * BANKS; i += THREADS) T[i] = te0[i / BANKS];
  __syncthreads();
  const int bank = threadIdx.x % BANKS;
  const uint32_t* ksw = reinterpret_cast<const uint32_t*>(ks);
  const long long steps = (n + WORDS - 1) / WORDS;
  for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
    // this step's words lie in keystream blocks g * THREADS ... + THREADS
    for (int j = threadIdx.x; j <= (offset ? THREADS : THREADS - 1); j += THREADS) {
      const uint64_t b = static_cast<uint64_t>(g) * THREADS + j;
      const uint64_t l = ctr_lo + b;
      ks[j] = aes_block(T, bank, rk, ctr_hi + (l < ctr_lo), l);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = threadIdx.x + k * THREADS;
      const long long w = g * WORDS + i;
      if (w < n) {
        const int p = offset + 8 * i;   // the word's first byte in ks
        const int q = p >> 2, sh = (p & 3) * 8;
        const uint64_t v = (static_cast<uint64_t>(__funnelshift_r(ksw[q + 1], ksw[q + 2], sh))
                            << 32) | __funnelshift_r(ksw[q], ksw[q + 1], sh);
        uint64_t r = v - __umul64hi(v, mu) * span;
        if (r >= span) r -= span;
        const int32_t word = static_cast<int32_t>(static_cast<uint32_t>(r) + lo);
        out[w] = word;
        if (host) host[w] = word;
      }
    }
    __syncthreads();
  }
}

int draw(const void* te0, const void* round_keys, unsigned long long ctr_hi,
         unsigned long long ctr_lo, int offset, unsigned lo, unsigned span,
         unsigned long long mu, void* out, void* host, long long n, cudaEvent_t done,
         cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if ((err = cudaStreamIsCapturing(s, &capture)) != cudaSuccess) return static_cast<int>(err);
  const bool captured = capture != cudaStreamCaptureStatusNone;
  if (host && captured) return static_cast<int>(cudaErrorStreamCaptureUnsupported);
  RoundKeys rk;
  std::memcpy(&rk, round_keys, sizeof rk);
  const long long steps = (n + WORDS - 1) / WORDS;
  const unsigned grid = static_cast<unsigned>(steps < MAX_GRID ? steps : MAX_GRID);
  ctr_mod_kernel<<<grid, THREADS, 0, s>>>(static_cast<const uint32_t*>(te0), rk, ctr_hi, ctr_lo,
                                          offset, lo, span, mu, static_cast<int32_t*>(out),
                                          static_cast<int32_t*>(host), n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (host && (err = cudaEventRecord(done, s)) != cudaSuccess) return static_cast<int>(err);
  return captured ? -1 : 0;
}

}  // namespace

extern "C" int apsu_ctr_mod(const void* te0, const void* round_keys, unsigned long long ctr_hi,
                            unsigned long long ctr_lo, int offset, unsigned lo, unsigned span,
                            unsigned long long mu, void* out, void* host, long long n,
                            void* done, int device, void* stream) {
  if (n <= 0 || offset < 0 || offset > 15 || span == 0 || (host && !done))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int r = draw(te0, round_keys, ctr_hi, ctr_lo, offset, lo, span, mu, out, host, n,
                     static_cast<cudaEvent_t>(done), static_cast<cudaStream_t>(stream));
  if (current != device && (err = cudaSetDevice(current)) != cudaSuccess && r <= 0)
    return static_cast<int>(err);
  return r;
}
