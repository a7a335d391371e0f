// Matching-polynomial dot product for sm_90a:
//   out[b, c, comp] = sum_{j=1..D} powers[b, j-1, comp] (.)_mont cache[b, c, j]
// per limb l and lane n, comp in {0, 1} (the two ciphertext components).
//
// Replaces the TPU kernel apsu_tpu/ops/polyeval.py:eval_dot_pallas, whose
// grid (B, C / cb, Dp / 8) walks the plane axis in order on one core and
// carries each block of cb caches' sums in VMEM from one 8-plane chunk to
// the next.
//
// What bounds it on the H100: device-memory bytes, at 3.35 TB/s (and at the
// measured stream ceiling, 2.95-2.99 TB/s, PERF.md section 6).  Planes
// 1..D of every cache and the D power planes must stream in once and the
// [B, C, 2, L, N] output must be written once; the products, two 32x32->64
// multiply-adds a cache residue, take under a fifth of the bytes' time.
// The first design here (one thread an output lane for a block of four
// caches, the plane axis walked serially) read 29-53% of that bound at the
// paths' shapes and 9% at 520 planes: too few threads (32 blocks at B=1,
// C=3), the powers re-read once per four caches, 64-bit index divisions.
// This design:
//
// 1. A block owns a tile of 64 or 128 lanes of one (bundle b, limb l), a
//    chunk of up to MAX_CACHES of that bundle's caches and one contiguous
//    range of the plane axis.  The launch plan (ops/polyeval.py:
//    eval_dot_plan, passed in by the wrapper) picks the tile and splits the
//    plane axis into up to MAX_SPLIT ranges so that the card holds about
//    three 128-lane blocks' worth of lanes an SM, the B=1 shapes too, with
//    every cluster resident at once: it asks the card how many fit
//    (apsu_eval_dot_clusters), since a cluster left for a second wave
//    doubles the time and the count differs from card to card.  Indices
//    come from a 3-D grid (lane tile, limb, bundle x cache chunk x plane
//    range) in 32-bit arithmetic, with two 32-bit divisions a thread at the
//    start; no lane divides.
// 2. The plane ranges of one tile are the blocks of one thread-block
//    cluster.  Each block reduces its own sums to canonical residues and
//    leaves them in its shared memory; after a cluster barrier, block s of
//    the cluster adds the ranges' residues of output rows s, s + split, ...
//    mod p through distributed shared memory and writes them.  No scratch
//    tensor, no second pass, no atomics.  The bits cannot change with the
//    split: every range's partial is the canonical residue of (its sum of
//    products) * 2^-32 mod p, and the sum of those mod p is the one
//    canonical residue of (the whole sum) * 2^-32 mod p, in any grouping;
//    eval_dot_plain folds per 8-plane chunk and gets the same residue.
// 3. Each power plane is read once per (bundle, limb, lane tile, cache
//    chunk): one cache chunk at every path shape, so exactly once.  A
//    thread walks its range plane by plane and, at each plane, multiplies
//    the two power residues into the sums of every cache of the chunk, kept
//    in registers (2 * MAXC u64, MAXC = 4, 8, 12 or 16 by the chunk, so a
//    small chunk leaves registers for more blocks an SM).
// 4. The planes stream through a ring of stages in shared memory by Hopper's
//    bulk asynchronous copies (cp.async.bulk, global to shared, completion
//    on an mbarrier): a stage holds stage_planes planes, each the two power
//    components and the chunk's caches at the tile's lanes, 256 or 512
//    contiguous bytes a slice (16-byte multiples, no tensor map).  The
//    block's last warp is the producer, lane k issuing slice k of each
//    plane, so one stage's copies go out in parallel.  The plan sizes the
//    stages and the ring (about 24 KB a 128-lane block: a deeper ring
//    crowded the card's memory and ran slower on the H100).  16-byte
//    cp.async by the producer warp in place of the bulk copies, timed in
//    turns (chip_smoke.py --compare-eval-dot at f5d52af), was no faster.
// 5. Arithmetic without division: two u64 sums a cache, one per component.
//    Every residue is < p < 2^30, so a product is < p^2 < 2^60.  Every
//    FOLD_EVERY = 8 products the high word of each sum is brought below p
//    by conditional subtractions (fold()), which keeps the sum mod p.
//    Worst case, every residue p - 1: a fold leaves s < p * 2^32; eight more
//    products add < 8p^2, so s < p * 2^32 + 8p^2 < 2^62 + 2^63 < 2^64 (no
//    u64 wrap) and hi(s) < p + 8p^2 / 2^32 < p + 2p = 3p, which two
//    subtractions bring below p.  The first eight products from 0 give
//    s < 8p^2 < 2^63, hi < 2p.  At the end one fold and one Montgomery
//    reduction (s + m*p < 2p * 2^32 < 2^63, t < 2p, one subtraction) give
//    the canonical residue; the cross-range adds are add_mod.  No division
//    of any width, no precomputed constant.
//
// Plane 0 of the cache (the constant coefficient) and its zero-padded tail
// are never read: the power tensor comes unpadded, [B, D, 2, L, N], and
// plane j of the cache pairs with power j-1.  The bulk copies need
// N % 4 == 0 and 16-byte aligned tensors (the wrapper checks).  The
// helpers below are the ones csrc/ps_inner.cu uses; each source compiles
// alone (ops/_build.py builds each on its own).
//
// The entry point allocates nothing, launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_TILE = 128;       // lanes a block, one compute thread each
constexpr int THREADS = MAX_TILE + 32;   // at most: the compute warps and one producer warp
constexpr int MAX_CACHES = 16;      // caches a block sums (registers)
constexpr int MAX_SPLIT = 8;        // plane ranges a tile: blocks of a portable cluster
constexpr int MAX_STAGES = 16;
constexpr int FOLD_EVERY = 8;
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;   // full[], empty[]
constexpr int MAX_SMEM = 232448;

struct Args {
  const uint32_t* powers;
  const uint32_t* cache;
  uint32_t* out;
  const uint32_t* primes;
  const uint32_t* p_neg_inv;
  int C, D, Dp, L, N;
  int tile;           // lanes a block: 64 or 128
  int cache_chunks;   // blocks along one bundle's caches
  int caches;         // caches a block (the last chunk may hold fewer)
  int split;          // plane ranges a tile = blocks of a cluster
  int planes;         // planes a range (the last may hold fewer)
  int stage_planes;   // planes a ring stage
  int stages;         // ring stages
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, counted against bar's transaction bytes when they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a * b + c for u32 a, b and u64 c: one IMAD.WIDE.U32
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

// s with its high word brought below p (s mod p unchanged), for hi(s) < 3p
__device__ __forceinline__ uint64_t fold(uint64_t s, uint32_t p) {
  uint32_t hi = static_cast<uint32_t>(s >> 32);
  hi = hi >= p ? hi - p : hi;
  hi = hi >= p ? hi - p : hi;
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(s);
}

// canonical s * 2^-32 mod p for s < p * 2^32 (a folded sum): with hi < p,
// (hi * 2^32 + lo + m*p) / 2^32 = hi + (lo + m*p) / 2^32 < p + p + 1
__device__ __forceinline__ uint32_t redc(uint64_t s, uint32_t p, uint32_t pni) {
  const uint32_t hi = static_cast<uint32_t>(s >> 32);
  const uint32_t lo = static_cast<uint32_t>(s);
  const uint32_t t = hi + static_cast<uint32_t>(mad_wide(lo * pni, p, lo) >> 32);
  return t >= p ? t - p : t;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

template <int MAXC>
__global__ void __launch_bounds__(THREADS) eval_dot_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + BARRIER_BYTES);
  cg::cluster_group cluster = cg::this_cluster();

  const int T = a.tile;
  const int n0 = blockIdx.x * T;
  const int nt = min(T, a.N - n0);   // lanes of this tile, a multiple of 4
  const int l = blockIdx.y;
  const int s = static_cast<int>(cluster.block_rank());   // = blockIdx.z % split
  const int bq = blockIdx.z / a.split;
  const int b = bq / a.cache_chunks;
  const int c0 = (bq - b * a.cache_chunks) * a.caches;
  const int nc = min(a.caches, a.C - c0);
  const int j0 = 1 + s * a.planes;       // first cache plane of this range
  const int nj = min(a.planes, a.D + 1 - j0);
  const int rows = 2 + nc;                // slices a plane: two power components, nc caches
  const int stage_elems = a.stage_planes * rows * T;
  const int LN = a.L * a.N;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], T);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t p = a.primes[l];
  if (threadIdx.x >= T) {   // the producer warp: lane k issues slice k of each plane
    const int lane = threadIdx.x - T;
    const uint32_t slice_bytes = static_cast<uint32_t>(nt) * 4;
    const uint32_t* src = nullptr;
    int64_t plane_step = 0;
    if (lane < 2) {   // power j0 - 1 + i, component lane
      src = a.powers + (static_cast<int64_t>(b * a.D + j0 - 1) * 2 + lane) * LN +
            l * a.N + n0;
      plane_step = 2 * static_cast<int64_t>(LN);
    } else if (lane < rows) {   // plane j0 + i of cache c0 + lane - 2
      src = a.cache + (static_cast<int64_t>(b * a.C + c0 + lane - 2) * a.Dp + j0) * LN +
            l * a.N + n0;
      plane_step = LN;
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0, k = 0; g < nj; g += a.stage_planes, ++k) {
      const int n = min(a.stage_planes, nj - g);
      if (k >= a.stages) mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) mbar_expect_tx(&full[stage], n * rows * slice_bytes);
      __syncwarp();
      if (lane < rows) {
        uint32_t* dst = ring + stage * stage_elems + lane * T;
        for (int i = 0; i < n; ++i)
          bulk_load(dst + i * rows * T, src + (g + i) * plane_step, slice_bytes,
                    &full[stage]);
      }
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    const int t = threadIdx.x;
    const uint32_t pni = a.p_neg_inv[l];
    uint64_t s0[MAXC], s1[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) s0[c] = s1[c] = 0;
    int stage = 0, since = 0;
    uint32_t phase = 0;
    for (int g = 0; g < nj; g += a.stage_planes) {
      const int n = min(a.stage_planes, nj - g);
      mbar_wait(&full[stage], phase);
      const uint32_t* sb = ring + stage * stage_elems + t;
      for (int i = 0; i < n; ++i) {
        const uint32_t* slice = sb + i * rows * T;
        const uint32_t a0 = slice[0], a1 = slice[T];
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < nc) {
            const uint32_t x = slice[(2 + c) * T];
            s0[c] = mad_wide(a0, x, s0[c]);
            s1[c] = mad_wide(a1, x, s1[c]);
          }
        }
        if (++since == FOLD_EVERY) {
          since = 0;
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            if (c < nc) {
              s0[c] = fold(s0[c], p);
              s1[c] = fold(s1[c], p);
            }
          }
        }
      }
      mbar_arrive(&empty[stage]);
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the range's canonical partials, row 2c + comp, into column t of the
    // ring (the plan sizes it for them): this thread has waited on every
    // stage, so every copy has landed, and the other threads read only their
    // own columns
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
        ring[(2 * c) * T + t] = redc(fold(s0[c], p), p, pni);
        ring[(2 * c + 1) * T + t] = redc(fold(s1[c], p), p, pni);
      }
    }
  }
  cluster.sync();   // every range's partials are in its block's shared memory

  if (threadIdx.x < T) {
    const int t = threadIdx.x;
    uint32_t* o = a.out + static_cast<int64_t>(b * a.C + c0) * 2 * LN + l * a.N + n0 + t;
    for (int r = s; r < 2 * nc; r += a.split) {
      uint32_t v = 0;
      for (int k = 0; k < a.split; ++k)
        v = add_mod(v, cluster.map_shared_rank(ring, k)[r * T + t], p);
      if (t < nt) o[static_cast<int64_t>(r) * LN] = v;
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// Launches the kernel, or with ``clusters`` set only reports how many of its
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).
template <int MAXC>
cudaError_t launch(const Args& a, int B, int smem, cudaStream_t stream, int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(eval_dot_kernel<MAXC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + a.tile - 1) / a.tile, a.L,
                     static_cast<unsigned>(B * a.cache_chunks * a.split));
  cfg.blockDim = dim3(a.tile + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, eval_dot_kernel<MAXC>, &cfg);
  return cudaLaunchKernelEx(&cfg, eval_dot_kernel<MAXC>, a);
}

// plan: lane tile, cache chunks, caches a block, plane ranges, planes a
// range, planes a stage, stages, dynamic shared memory bytes (the fields of
// ops/polyeval.py:eval_dot_plan, which this checks)
cudaError_t run(const void* powers, const void* cache, void* out, const void* primes,
                const void* p_neg_inv, int B, int C, int D, int Dp, int L, int N,
                const int* plan, cudaStream_t st, int* clusters) {
  Args a{static_cast<const uint32_t*>(powers), static_cast<const uint32_t*>(cache),
         static_cast<uint32_t*>(out), static_cast<const uint32_t*>(primes),
         static_cast<const uint32_t*>(p_neg_inv), C, D, Dp, L, N, plan[0],
         plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const int smem = plan[7];
  const bool ok =
      (a.tile == 64 || a.tile == MAX_TILE) && N % 4 == 0 && D >= 1 && D < Dp &&
      a.caches >= 1 && a.caches <= MAX_CACHES &&
      static_cast<int64_t>(a.cache_chunks) * a.caches >= C &&
      (a.cache_chunks - 1) * a.caches < C && a.split >= 1 && a.split <= MAX_SPLIT &&
      static_cast<int64_t>(a.split) * a.planes >= D && (a.split - 1) * a.planes < D &&
      a.stage_planes >= 1 && a.stage_planes <= a.planes && a.stages >= 1 &&
      a.stages <= MAX_STAGES &&
      smem == BARRIER_BYTES + max(a.stages * a.stage_planes * (2 + a.caches), 2 * a.caches) *
                                  a.tile * 4 &&
      smem <= MAX_SMEM && static_cast<int64_t>(B) * a.cache_chunks * a.split <= 65535 &&
      L <= 65535;
  if (!ok) return cudaErrorInvalidValue;
  if (a.caches <= 4) return launch<4>(a, B, smem, st, clusters);
  if (a.caches <= 8) return launch<8>(a, B, smem, st, clusters);
  if (a.caches <= 12) return launch<12>(a, B, smem, st, clusters);
  return launch<MAX_CACHES>(a, B, smem, st, clusters);
}

}  // namespace

extern "C" int apsu_eval_dot_split(const void* powers, const void* cache, void* out,
                                   const void* primes, const void* p_neg_inv, int B, int C,
                                   int D, int Dp, int L, int N, const int* plan, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(B) * C * L * N;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  if (D == 0)   // no power: every sum is empty
    return static_cast<int>(cudaMemsetAsync(out, 0, static_cast<size_t>(total) * 2 * 4, st));
  cudaError_t err = run(powers, cache, out, primes, p_neg_inv, B, C, D, Dp, L, N, plan, st,
                        nullptr);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// How many clusters of the plan's launch the current card holds at once.
extern "C" int apsu_eval_dot_clusters(int B, int C, int D, int Dp, int L, int N, const int* plan,
                                      int* clusters) {
  return static_cast<int>(run(nullptr, nullptr, nullptr, nullptr, nullptr, B, C, D, Dp, L, N,
                              plan, nullptr, clusters));
}
