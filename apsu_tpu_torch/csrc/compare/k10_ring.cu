// K10 comparison (apsu_add_one only): Hopper's ring of bulk asynchronous
// copies.  Block b owns 16 KB tiles b, b + G, b + 2G, ... (G blocks, two an
// SM); thread 0 loads each tile by cp.async.bulk global -> shared on the
// stage's mbarrier, keeping STAGES - 1 loads ahead, every thread adds 1 in
// shared memory, and thread 0 stores the stage by cp.async.bulk shared ->
// global and refills it once that store has read it.  A launch of less than
// one tile takes plain 16-byte loads, ADD_UNROLL in flight a thread; the
// vectors after the last whole tile and the last n % 4 elements are the last
// block's, by plain loads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ADD_THREADS = 256;
constexpr int ADD_UNROLL = 8;   // 16-byte loads in flight a thread
constexpr int RING_THREADS = 256;
constexpr int STAGE_BYTES = 16384;
constexpr int STAGE_VECS = STAGE_BYTES / 16;
constexpr int STAGE_ELEMS = STAGE_BYTES / 4;
constexpr int STAGES = 6;
constexpr int RING_BLOCKS_PER_SM = 2;
constexpr int RING_SMEM = STAGES * STAGE_BYTES + STAGES * 8;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint4 plus_one(uint4 v) {
  return make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
}

// vectors [v0, v1) and the scalars [4 * v1, n) by one block's threads
__device__ __forceinline__ void add_one_rest(const uint32_t* __restrict__ x,
                                             uint32_t* __restrict__ out, int64_t v0,
                                             int64_t v1, int64_t n) {
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  for (int64_t k = v0 + threadIdx.x; k < v1; k += blockDim.x) o4[k] = plus_one(x4[k]);
  if (threadIdx.x < n - 4 * v1) out[4 * v1 + threadIdx.x] = x[4 * v1 + threadIdx.x] + 1u;
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
    if (base + k * ADD_THREADS < n4) o4[base + k * ADD_THREADS] = plus_one(v[k]);
  }
  if (blockIdx.x == 0) add_one_rest(x, out, n4, n4, n);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one tile from global to shared memory, its bytes counted against bar
__device__ __forceinline__ void tile_load(void* dst, const void* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(STAGE_BYTES)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(STAGE_BYTES), "r"(smem_addr(bar))
      : "memory");
}

// one tile from shared to global memory, as its own bulk group
__device__ __forceinline__ void tile_store(void* dst, const void* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(STAGE_BYTES)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Block b owns tiles b, b + G, b + 2G, ... of `tiles` whole 16 KB tiles.  Its
// j-th tile lands in stage j % STAGES; thread 0 keeps STAGES - 1 loads ahead
// and refills a stage once the bulk store that last read it has read it.
__global__ void __launch_bounds__(RING_THREADS)
add_one_ring(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
             int64_t tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  const int64_t G = gridDim.x;
  const int64_t mine = (tiles - blockIdx.x + G - 1) / G;
  auto src = [&](int64_t j) { return x + (blockIdx.x + j * G) * STAGE_ELEMS; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int64_t j = 0; j < STAGES - 1 && j < mine; ++j) {
      tile_load(stage + j * STAGE_VECS, src(j), &full[j]);
    }
  }
  __syncthreads();
  if (blockIdx.x == G - 1) add_one_rest(x, out, tiles * STAGE_VECS, n / 4, n);
  for (int64_t j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % STAGES);
    uint4* v = stage + s * STAGE_VECS;
    mbar_wait(&full[s], static_cast<uint32_t>(j / STAGES) & 1u);
#pragma unroll
    for (int k = threadIdx.x; k < STAGE_VECS; k += RING_THREADS) v[k] = plus_one(v[k]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      tile_store(out + (blockIdx.x + j * G) * STAGE_ELEMS, v);
      // the store of tile j - 1 has read its stage: refill it with tile j + STAGES - 1
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      const int64_t next = j + STAGES - 1;
      if (next < mine) {
        const int t = static_cast<int>(next % STAGES);
        tile_load(stage + t * STAGE_VECS, src(next), &full[t]);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int sm_count() {
  static int sms[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(add_one_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  }
  return sms[dev];
}

}  // namespace

extern "C" int apsu_add_one(const void* x, void* out, long long n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  const int64_t tiles = n / STAGE_ELEMS;
  if (tiles >= 1) {
    const int64_t most = static_cast<int64_t>(sm_count()) * RING_BLOCKS_PER_SM;
    const int64_t blocks = tiles < most ? tiles : most;
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    add_one_ring<<<static_cast<unsigned>(blocks), RING_THREADS, RING_SMEM, s>>>(xi, o, n, tiles);
  } else if (n > 0) {
    const int64_t tile = static_cast<int64_t>(ADD_THREADS) * ADD_UNROLL;
    const int64_t blocks = (n / 4 + tile - 1) / tile;
    add_one_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), ADD_THREADS, 0, s>>>(xi, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}
