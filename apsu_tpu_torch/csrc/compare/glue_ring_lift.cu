// Comparison variant of G1's lift: step 3 by Hopper's bulk asynchronous
// copies instead of registers.  The package's arithmetic (../behz_lift.cu,
// its entry renamed here) for the exact pairs; a block owns THREADS lanes of
// ROWS rows (y, y + G, ...), and a producer warp keeps STAGES rows in shared
// memory ahead of the THREADS consumer threads: lane c of the producer warp
// copies limb c of a row's Lq limbs (THREADS words each, cp.async.bulk
// global -> shared on the stage's full mbarrier, the row found by
// behz.cuh's Rows); a consumer reads its lane's words of a stage, arrives on
// the stage's empty mbarrier, computes and stores.  Launches the ring does
// not take (other modes, a general pair, N not a multiple of THREADS, rows
// or limbs not 16-byte aligned) go to the package's entry.

#define apsu_behz_lift apsu_behz_lift_package
#include "../behz_lift.cu"
#undef apsu_behz_lift

namespace {

constexpr int RING_STAGES = 4;
constexpr int RING_ROWS = 8;   // rows a block

__device__ __forceinline__ uint32_t ring_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(ring_smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <int QN, int BN>
__global__ void __launch_bounds__(THREADS + 32)
lift_ring(const uint32_t* __restrict__ x, const Rows xw, long long x_limb,
          uint32_t* __restrict__ out_q, uint32_t* __restrict__ out_b, long long rows, int n,
          const LiftTable t) {
  constexpr uint32_t LIMB_BYTES = THREADS * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);   // [RING_STAGES][QN][THREADS]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_STAGES * QN * LIMB_BYTES);
  uint64_t* empty = full + RING_STAGES;
  const int lane0 = blockIdx.x * THREADS;
  const long long G = gridDim.y;
  const long long mine = (rows - blockIdx.y + G - 1) / G;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(ring_smem(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(ring_smem(&empty[s])),
                   "r"(THREADS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= THREADS) {   // the producer warp
    const int c = threadIdx.x - THREADS;
    for (long long k = 0; k < mine; ++k) {
      const int s = static_cast<int>(k % RING_STAGES);
      if (k >= RING_STAGES) ring_wait(&empty[s], ((k / RING_STAGES) - 1) & 1);
      if (c == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                         ring_smem(&full[s])),
                     "r"(QN * LIMB_BYTES)
                     : "memory");
      __syncwarp();
      if (c < QN) {
        const uint32_t* src = x + row_at(xw, blockIdx.y + k * G) + c * x_limb + lane0;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(ring_smem(stage + (s * QN + c) * THREADS)),
            "l"(src), "r"(LIMB_BYTES), "r"(ring_smem(&full[s]))
            : "memory");
      }
    }
    return;
  }
  const int lane = lane0 + threadIdx.x;
  for (long long k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % RING_STAGES);
    const long long r = blockIdx.y + k * G;
    ring_wait(&full[s], (k / RING_STAGES) & 1);
    const uint32_t* st = stage + s * QN * THREADS + threadIdx.x;
    uint32_t c[QN];
#pragma unroll
    for (int i = 0; i < QN; ++i) c[i] = st[i * THREADS];
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(ring_smem(&empty[s]))
                 : "memory");
    uint32_t c16 = 0;
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      if (out_q != nullptr)
        out_q[(r * QN + i) * n + lane] = shoup(c[i], t.qm[i], t.qm_sh[i], t.q[i]);
      c[i] = shoup(c[i], t.c[i], t.c_sh[i], t.q[i]);
      c16 += (c[i] & 0xFFFFu) * t.phat_mt[i];
    }
    const uint32_t sm = ((c16 & 0xFFFFu) * t.q_inv_mt) & 0xFFFFu;
    const uint32_t rr = (0x10000u - sm) & 0xFFFFu;
    const bool neg = rr >= 0x8000u;
    const uint32_t r_abs = neg ? 0x10000u - rr : rr;
    uint32_t* o = out_b + r * BN * n + lane;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      uint64_t acc = mad_wide(r_abs, neg ? t.kn[j] : t.k[j], 0);
#pragma unroll
      for (int i = 0; i < QN; ++i) acc = mad_wide(c[i], t.ma[i][j], acc);
      o[j * n] = reduce64(acc, t.b32[j], t.b32_sh[j], t.b_one_sh[j], t.b[j]);
    }
  }
}

}  // namespace

extern "C" int apsu_behz_lift(const void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, void* out_q, void* out_b,
                              long long rows, int n, int lq, int lb, int mode,
                              const void* table, void* stream) {
  const bool mine = mode == LIFT && n > 0 && n % THREADS == 0 && rows > 0 &&
                    rows < (1LL << 31) && x_inner >= 1 && x_inner < (1LL << 31) &&
                    out_b != nullptr && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    x_limb % 4 == 0 && x_stride % 4 == 0 && x_outer % 4 == 0;
  auto run = [&](auto kernel, int q) {
    const int smem = RING_STAGES * q * THREADS * 4 + 2 * RING_STAGES * 8;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    LiftTable t;
    std::memcpy(&t, table, sizeof t);
    const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
    kernel<<<grid_for(rows, n, RING_ROWS), THREADS + 32, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), xw, x_limb, static_cast<uint32_t*>(out_q),
        static_cast<uint32_t*>(out_b), rows, n, t);
    return static_cast<int>(cudaGetLastError());
  };
#define RING_CASE(Q, B) \
  if (mine && lq == Q && lb == B) return run(lift_ring<Q, B>, Q);
  BEHZ_EXACT_PAIRS(RING_CASE)
#undef RING_CASE
  return apsu_behz_lift_package(x, x_inner, x_stride, x_outer, x_limb, out_q, out_b, rows, n, lq,
                                lb, mode, table, stream);
}
