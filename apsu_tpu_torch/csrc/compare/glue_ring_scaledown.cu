// Comparison variant of G3: step 3 by Hopper's bulk asynchronous copies
// instead of registers.  The package's arithmetic (../behz_scaledown.cu, its
// entry renamed here) for the exact pairs; a block owns THREADS lanes of
// ROWS rows (y, y + G, ...), and a producer warp keeps STAGES rows in shared
// memory ahead of the THREADS consumer threads: lane c of the producer warp
// copies limb c of a row's Lq + Lb limbs (THREADS words each, cp.async.bulk
// global -> shared on the stage's full mbarrier); a consumer reads its
// lane's words of a stage, arrives on the stage's empty mbarrier, computes
// and stores.  Calls the ring does not take (a general pair, N not a
// multiple of THREADS) go to the package's entry.

#define apsu_behz_scaledown apsu_behz_scaledown_package
#include "../behz_scaledown.cu"
#undef apsu_behz_scaledown

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
scaledown_ring(const uint32_t* __restrict__ xq, const uint32_t* __restrict__ xb,
               uint32_t* __restrict__ out, long long rows, int n, const ScaleTable t) {
  constexpr int W = QN + BN;
  constexpr uint32_t LIMB_BYTES = THREADS * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);   // [RING_STAGES][W][THREADS]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING_STAGES * W * LIMB_BYTES);
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
                     "r"(W * LIMB_BYTES)
                     : "memory");
      __syncwarp();
      const long long r = blockIdx.y + k * G;
      if (c < W) {
        const uint32_t* src = c < QN ? xq + (r * QN + c) * n + lane0
                                     : xb + (r * BN + (c - QN)) * n + lane0;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(ring_smem(stage + (s * W + c) * THREADS)),
            "l"(src), "r"(LIMB_BYTES), "r"(ring_smem(&full[s]))
            : "memory");
      }
    }
    return;
  }
  const int lane = lane0 + threadIdx.x;
  constexpr int nb = BN - 1;
  const uint32_t msk = t.b[nb];
  for (long long k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % RING_STAGES);
    ring_wait(&full[s], (k / RING_STAGES) & 1);
    const uint32_t* st = stage + s * W * THREADS + threadIdx.x;
    uint32_t y[QN], vb[BN];
#pragma unroll
    for (int i = 0; i < QN; ++i) y[i] = st[i * THREADS];
#pragma unroll
    for (int j = 0; j < BN; ++j) vb[j] = st[(QN + j) * THREADS];
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(ring_smem(&empty[s]))
                 : "memory");
#pragma unroll
    for (int i = 0; i < QN; ++i) y[i] = shoup(y[i], t.yq[i], t.yq_sh[i], t.q[i]);
    uint32_t w[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      uint64_t acc = mad_wide(vb[j], t.wx[j], 0);
#pragma unroll
      for (int i = 0; i < QN; ++i) acc = mad_wide(y[i], t.wy[i][j], acc);
      w[j] = reduce64(acc, t.b32[j], t.b32_sh[j], t.b_one_sh[j], t.b[j]);
    }
    uint64_t sa = 0;
#pragma unroll
    for (int j = 0; j < BN; ++j) sa = mad_wide(w[j], t.ak[j], sa);
    const uint32_t alpha = reduce64(sa, t.b32[nb], t.b32_sh[nb], t.b_one_sh[nb], msk);
    const bool neg = alpha >= t.msk_half;
    const uint32_t a_abs = neg ? msk - alpha : alpha;
    uint32_t* o = out + (blockIdx.y + k * G) * QN * n + lane;
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      uint64_t acc = mad_wide(a_abs, neg ? t.pbq[i] : t.npbq[i], 0);
#pragma unroll
      for (int j = 0; j < nb; ++j) acc = mad_wide(w[j], t.mb[j][i], acc);
      o[i * n] = reduce64(acc, t.q32[i], t.q32_sh[i], t.q_one_sh[i], t.q[i]);
    }
  }
}

}  // namespace

extern "C" int apsu_behz_scaledown(const void* xq, const void* xb, void* out, long long rows,
                                   int n, int lq, int lb, const void* table, void* stream) {
  const bool mine = n > 0 && n % THREADS == 0 && rows > 0;
  auto run = [&](auto kernel, int w) {
    const int smem = RING_STAGES * w * THREADS * 4 + 2 * RING_STAGES * 8;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ScaleTable t;
    std::memcpy(&t, table, sizeof t);
    kernel<<<grid_for(rows, n, RING_ROWS), THREADS + 32, smem,
             static_cast<cudaStream_t>(stream)>>>(static_cast<const uint32_t*>(xq),
                                                  static_cast<const uint32_t*>(xb),
                                                  static_cast<uint32_t*>(out), rows, n, t);
    return static_cast<int>(cudaGetLastError());
  };
#define RING_CASE(Q, B) \
  if (mine && lq == Q && lb == B) return run(scaledown_ring<Q, B>, Q + B);
  BEHZ_EXACT_PAIRS(RING_CASE)
#undef RING_CASE
  return apsu_behz_scaledown_package(xq, xb, out, rows, n, lq, lb, table, stream);
}
