// Paterson-Stockmeyer inner sums for sm_90a:
//   out[r, k, c] = sum_{i=1..ph-1} low[r / C, i-1, c] (.)_mont cache[r, k*ph + i]
// per limb l and lane n, c in {0, 1} (the two ciphertext components).
//
// Replaces the TPU kernel apsu_tpu/ops/polyeval.py:eval_ps_inner_pallas3, whose
// grid (R, ph) keeps all nseg segments of a cache row resident so that each
// low-power plane is loaded once per row.
//
// What bounds it on the H100: device-memory bytes.  Planes 1..ph-1 of every
// segment of the cache must stream in once and the [R, nseg, 2, L, N] output
// must be written once; the low powers are small beside the cache (2 MB
// against 232 MB at 1M-2048-com, 46 MB against 4 GB at 16M-4096) and the
// products are few (0.26 ms of 32x32->64 products against 1.42 ms of bytes
// at 16M-4096).  So the design spends no bytes, no L2 traffic and no integer
// issue slots beyond what that stream needs:
//
// 1. A block owns a tile of TILE lanes of one (bundle b, limb l) and a chunk
//    of that bundle's C*nseg output rows (row j is cache row b*C + j/nseg,
//    segment j%nseg, and output row b*C*nseg + j).  Indices come from a 3-D
//    grid (lane tile, limb, bundle x row chunk) in 32-bit arithmetic; only
//    the cache's and the output's row offsets are 64-bit (a 16M-4096 cache
//    view spans 1.03e9 elements).  No lane divides.  (The one-thread-a-lane
//    design this replaces decoded its index with seven 64-bit divisions a
//    lane; taking only those out of it gained 4% at ph=6 on the H100, so
//    the two points below carry the redesign.)
// 2. The low powers live in shared memory.  The block copies its
//    2(ph-1)*TILE low residues there once, by the same bulk copies as the
//    cache (laid out [plane][component][TILE]), and every row of the chunk
//    reads them from there: each low residue comes from L2 or device memory
//    once a block, never once an output lane (the old design re-read the low
//    tensor C*nseg times over, 0.46 GB of L2 traffic at 1M-2048-com against
//    0.33 GB of device-memory bytes).  Where they do not fit beside the ring
//    (ph-1 > LOW_WHOLE, as 256M-1's ph=311), the block walks the low planes
//    in chunks of LOW_CHUNK through two buffers, the next chunk streaming in
//    while the last is read, and keeps each row's partial sums in registers
//    (at most MAX_ROWS_CHUNKED rows a block then).
// 3. The cache streams through a ring of STAGES buffers in shared memory by
//    Hopper's bulk asynchronous copies (cp.async.bulk, global to shared, with
//    completion on an mbarrier).  A stage is up to GROUP planes of one row;
//    each (row, plane) slice of a lane tile is TILE*4 contiguous bytes, so
//    1-D bulk copies need no tensor map.  The block's last warp is the
//    producer: it keeps STAGES stages in flight whatever ph is (a ph=6 row
//    no longer leaves each thread with five 4-byte loads in flight), lane q
//    issuing a stage's copy q, since one thread issuing a stage's eight
//    copies in series held a block to ~7 GB/s on the H100.
// 4. The arithmetic: two u64 sums a lane, one per component, of at most
//    GROUP = 8 products each.  Residues are < p < 2^30, so such a sum is
//    < 8p^2 and its high word < 2p: one conditional subtraction brings the
//    high word below p, one Montgomery reduction then gives t < 2p, and one
//    more conditional subtraction the canonical R^-1 * sum mod p.  Those
//    partial sums are added mod p.  No division of any width is left, and
//    every prime < 2^30 and every ph is taken.  The result is the canonical
//    R^-1 * sum(a*b) mod p, which the reference computes too (it adds
//    canonical Montgomery partial sums), so outputs are bit-identical.
//    Stores are 4 bytes a lane; a warp's 32 lanes fill whole 128-byte lines.
// 5. No tensor cores.  The contraction is per lane, a [nseg x (ph-1)] times
//    [(ph-1) x 2] product for each (l, n) on 30-bit residues mod p; an int8
//    IMMA split would take 16 byte-products for each residue product, and
//    the kernel is bound by bytes anyway.
//
// The cache is addressed through its row stride, so the evaluator's strided
// view cache_r[:, :nseg*ph] is read in place, never copied.  The bulk copies
// need N % 4 == 0, a 16-byte aligned low tensor and a 16-byte aligned cache
// view with a row stride that is a multiple of 4 elements (the wrapper
// checks).  The launcher picks the row chunk from the card's SM count and
// the kernel's occupancy (see launch()).
//
// The entry point allocates nothing, launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;                  // lanes a block, one compute thread each
constexpr int THREADS = TILE + 32;         // the compute warps and one producer warp
constexpr int GROUP = 8;                   // planes a stage; products a reduction
constexpr int STAGES = 6;
constexpr int LOW_WHOLE = 64;              // most low planes held whole in shared memory
constexpr int LOW_CHUNK = 24;              // else: planes a chunk, two chunk buffers
constexpr int MAX_ROWS_CHUNKED = 8;        // rows a block when the low planes are chunked
// full[STAGES], empty[STAGES], low_full[2], low_empty[2], padded to 128 bytes
constexpr int BARRIER_BYTES = ((2 * STAGES + 4) * 8 + 127) / 128 * 128;
constexpr int MAX_SMEM = BARRIER_BYTES + STAGES * GROUP * TILE * 4 + LOW_WHOLE * TILE * 8;

struct Args {
  const uint32_t* low;
  const uint32_t* cache;
  uint32_t* out;
  const uint32_t* primes;
  const uint32_t* p_neg_inv;
  int64_t row_stride;   // cache elements between rows r and r+1
  int C, nseg, ph, L, N;
  int rows_per_block;   // output rows of a bundle a block owns (the last may own fewer)
  int row_chunks;       // blocks along one bundle's rows
  int stage_planes;     // min(GROUP, ph-1)
  int low_planes;       // planes a low chunk: ph-1, or LOW_CHUNK
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

// a * b + c for u32 a, b and u64 c: one IMAD.WIDE.U32 (from C++ ptxas adds
// an instruction for the zero high word, see roofline.cu)
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

// canonical s * 2^-32 mod p for a sum s of at most GROUP products of residues
// < p < 2^30: s < 8p^2, so hi(s) < 2p; after one subtraction hi < p, and
// (hi*2^32 + lo + m*p) / 2^32 = hi + (lo + m*p) / 2^32 < p + p + 1
__device__ __forceinline__ uint32_t reduce_group(uint64_t s, uint32_t p, uint32_t pni) {
  uint32_t hi = static_cast<uint32_t>(s >> 32);
  hi = hi >= p ? hi - p : hi;
  const uint32_t lo = static_cast<uint32_t>(s);
  const uint32_t t = hi + static_cast<uint32_t>(mad_wide(lo * pni, p, lo) >> 32);
  return t >= p ? t - p : t;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

// One output row's sums over the qn planes of the low chunk in shared
// memory (laid out [plane][component][TILE]), stage by stage as the producer
// streams them; each stage is released as soon as its planes are read.  Adds
// into r0, r1.
__device__ __forceinline__ void row_sums(const uint32_t* stage_buf, const uint32_t* low_s,
                                         uint64_t* full, uint64_t* empty, int stage_planes,
                                         int qn, int& stage, uint32_t& phase, uint32_t p,
                                         uint32_t pni, int t, uint32_t& r0, uint32_t& r1) {
  for (int g = 0; g < qn; g += GROUP) {
    const int n = min(GROUP, qn - g);
    mbar_wait(&full[stage], phase);
    const uint32_t* sb = stage_buf + stage * stage_planes * TILE + t;
    const uint32_t* lw = low_s + g * 2 * TILE + t;
    uint64_t s0 = 0, s1 = 0;
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      if (q < n) {
        const uint32_t c = sb[q * TILE];
        s0 = mad_wide(c, lw[q * 2 * TILE], s0);
        s1 = mad_wide(c, lw[q * 2 * TILE + TILE], s1);
      }
    }
    mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    r0 = add_mod(r0, reduce_group(s0, p, pni), p);
    r1 = add_mod(r1, reduce_group(s1, p, pni), p);
  }
}

template <bool CHUNKED>
__global__ void __launch_bounds__(THREADS) ps_inner_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  uint64_t* low_full = empty + STAGES;
  uint64_t* low_empty = low_full + 2;
  uint32_t* stage_buf = reinterpret_cast<uint32_t*>(smem + BARRIER_BYTES);
  uint32_t* low_buf = stage_buf + STAGES * a.stage_planes * TILE;

  const int n0 = blockIdx.x * TILE;
  const int nt = min(TILE, a.N - n0);   // lanes of this tile, a multiple of 4
  const int l = blockIdx.y;
  const int b = blockIdx.z / a.row_chunks;
  const int j0 = (blockIdx.z - b * a.row_chunks) * a.rows_per_block;
  const int rows_b = a.C * a.nseg;
  const int nrows = min(a.rows_per_block, rows_b - j0);
  const int ell = a.ph - 1;
  const int lp = a.low_planes;
  const int LN = a.L * a.N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TILE);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&low_full[s], 1);
      mbar_init(&low_empty[s], TILE);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TILE) {   // the producer warp: lane q issues a stage's copy q
    const int lane = threadIdx.x - TILE;
    const uint32_t plane_bytes = static_cast<uint32_t>(nt) * 4;
    const uint32_t* low_src = a.low + static_cast<int64_t>(b) * ell * 2 * LN +
                              static_cast<int64_t>(l) * a.N + n0;
    int stage = 0, issued = 0;
    uint32_t phase = 0;
    for (int q0 = 0, lc = 0; q0 < ell; q0 += lp, ++lc) {
      const int q1 = min(q0 + lp, ell);
      // the chunk's low planes, into buffer lc % 2 once chunk lc - 2 is done
      const int slot = lc & 1;
      if (lc >= 2) mbar_wait(&low_empty[slot], ((lc >> 1) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&low_full[slot], 2 * (q1 - q0) * plane_bytes);
      __syncwarp();
      uint32_t* low_dst = low_buf + slot * lp * 2 * TILE;
      for (int i = lane; i < 2 * (q1 - q0); i += 32)   // [plane][component], as in global
        bulk_load(low_dst + i * TILE, low_src + static_cast<int64_t>(2 * q0 + i) * LN,
                  plane_bytes, &low_full[slot]);
      int r = b * a.C + j0 / a.nseg, k = j0 - (j0 / a.nseg) * a.nseg;
      for (int j = 0; j < nrows; ++j) {
        // plane q0 + 1 + lane of segment k of cache row r, at this tile's lanes of limb l
        const uint32_t* src = a.cache + r * a.row_stride +
                              static_cast<int64_t>(k * a.ph + q0 + 1 + lane) * LN +
                              static_cast<int64_t>(l) * a.N + n0;
        for (int g = q0; g < q1; g += GROUP) {
          const int n = min(GROUP, q1 - g);
          if (issued >= STAGES) mbar_wait(&empty[stage], phase ^ 1);
          if (lane == 0) mbar_expect_tx(&full[stage], n * plane_bytes);
          __syncwarp();
          if (lane < n)
            bulk_load(stage_buf + (stage * a.stage_planes + lane) * TILE,
                      src + static_cast<int64_t>(g - q0) * LN, plane_bytes, &full[stage]);
          ++issued;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (++k == a.nseg) {
          k = 0;
          ++r;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const bool live = t < nt;
  const uint32_t p = a.primes[l], pni = a.p_neg_inv[l];
  uint32_t* outp = a.out + static_cast<int64_t>(b * rows_b + j0) * 2 * LN +
                   static_cast<int64_t>(l) * a.N + n0 + t;
  int stage = 0;
  uint32_t phase = 0;
  uint32_t acc0[CHUNKED ? MAX_ROWS_CHUNKED : 1] = {}, acc1[CHUNKED ? MAX_ROWS_CHUNKED : 1] = {};

  for (int q0 = 0, lc = 0; q0 < ell; q0 += lp, ++lc) {
    const int qn = min(lp, ell - q0);
    const int slot = lc & 1;
    const uint32_t* low_s = low_buf + slot * lp * 2 * TILE;
    mbar_wait(&low_full[slot], (lc >> 1) & 1);
    if constexpr (CHUNKED) {
#pragma unroll
      for (int j = 0; j < MAX_ROWS_CHUNKED; ++j)
        if (j < nrows)
          row_sums(stage_buf, low_s, full, empty, a.stage_planes, qn, stage, phase, p, pni, t,
                   acc0[j], acc1[j]);
    } else {
      for (int j = 0; j < nrows; ++j) {
        uint32_t r0 = 0, r1 = 0;
        row_sums(stage_buf, low_s, full, empty, a.stage_planes, qn, stage, phase, p, pni, t, r0,
                 r1);
        if (live) {
          outp[static_cast<int64_t>(j) * 2 * LN] = r0;
          outp[static_cast<int64_t>(j) * 2 * LN + LN] = r1;
        }
      }
    }
    mbar_arrive(&low_empty[slot]);
  }
  if constexpr (CHUNKED) {
#pragma unroll
    for (int j = 0; j < MAX_ROWS_CHUNKED; ++j) {
      if (j < nrows && live) {
        outp[static_cast<int64_t>(j) * 2 * LN] = acc0[j];
        outp[static_cast<int64_t>(j) * 2 * LN + LN] = acc1[j];
      }
    }
  }
}

// The launch shape: stage and low-chunk planes, shared memory, occupancy
// and the row chunk.
template <bool CHUNKED>
cudaError_t plan(Args& a, int B, int& smem, int& occ) {
  const int ell = a.ph - 1;
  a.stage_planes = ell < GROUP ? ell : GROUP;
  a.low_planes = CHUNKED ? LOW_CHUNK : ell;
  smem = BARRIER_BYTES + STAGES * a.stage_planes * TILE * 4 +
         (CHUNKED ? 2 : 1) * a.low_planes * TILE * 8;
  cudaError_t err = cudaFuncSetAttribute(ps_inner_kernel<CHUNKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ps_inner_kernel<CHUNKED>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, nsm = 0;
  occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ps_inner_kernel<CHUNKED>, THREADS,
                                                        smem);
  if (err != cudaSuccess) return err;
  // row chunks, in units of one row's planes: an SM moves its share of all
  // blocks' rows plus the two rows' worth of low planes each block loads,
  // then waits on its last blocks, a tail that grows with the rows a block.
  // The tail's weight, occ^2 / 10 blocks, is fitted to the four shapes
  // chip_smoke.py's compare_ps_inner (at f5d52af) timed on the H100.  Take
  // the count that minimises the sum.
  const int rows = a.C * a.nseg;
  const int64_t tiles = static_cast<int64_t>((a.N + TILE - 1) / TILE) * a.L * B;
  const int most = rows < 64 ? rows : 64;
  int64_t best = -1;
  for (int n = 1; n <= most; ++n) {
    const int per = (rows + n - 1) / n;
    if (CHUNKED && per > MAX_ROWS_CHUNKED) continue;
    const int64_t chunks = (rows + per - 1) / per;
    const int64_t cost = 10 * tiles * (rows + 2 * chunks) / nsm + occ * occ * (per + 2);
    if (best < 0 || cost < best) {
      best = cost;
      a.rows_per_block = per;
    }
  }
  if (best < 0) a.rows_per_block = CHUNKED ? MAX_ROWS_CHUNKED : rows;
  a.row_chunks = (rows + a.rows_per_block - 1) / a.rows_per_block;
  const int64_t gz = static_cast<int64_t>(B) * a.row_chunks;
  if (gz > 65535 || a.L > 65535) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <bool CHUNKED>
cudaError_t launch(Args a, int B, cudaStream_t stream) {
  int smem = 0, occ = 0;
  const cudaError_t err = plan<CHUNKED>(a, B, smem, occ);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + TILE - 1) / TILE, a.L, static_cast<unsigned>(B * a.row_chunks));
  ps_inner_kernel<CHUNKED><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The launch shape apsu_ps_inner takes for these sizes, into shape[0..5]:
// lanes a block, rows a block, row chunks a bundle, blocks an SM, dynamic
// shared memory bytes, and 1 if the low planes come in chunks.
extern "C" int apsu_ps_inner_plan(int R, int C, int nseg, int ph, int L, int N, int* shape) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, C, nseg, ph, L, N, 0, 0, 0, 0};
  const bool chunked = ph - 1 > LOW_WHOLE;
  int smem = 0, occ = 0;
  const cudaError_t err = chunked ? plan<true>(a, R / C, smem, occ) : plan<false>(a, R / C, smem, occ);
  const int v[6] = {TILE, a.rows_per_block, a.row_chunks, occ, smem, chunked ? 1 : 0};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  return static_cast<int>(err);
}

extern "C" int apsu_ps_inner(const void* low, const void* cache, void* out,
                             const void* primes, const void* p_neg_inv,
                             long long cache_row_stride, int R, int C, int nseg,
                             int ph, int L, int N, void* stream) {
  const int64_t total = static_cast<int64_t>(R) * nseg * L * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total == 0) return static_cast<int>(cudaGetLastError());
  if (ph == 1)   // no low power: every sum is empty
    return static_cast<int>(cudaMemsetAsync(out, 0, static_cast<size_t>(total) * 2 * 4, s));
  Args a{static_cast<const uint32_t*>(low), static_cast<const uint32_t*>(cache),
         static_cast<uint32_t*>(out), static_cast<const uint32_t*>(primes),
         static_cast<const uint32_t*>(p_neg_inv), cache_row_stride, C, nseg, ph, L, N,
         0, 0, 0, 0};
  const int B = R / C;
  const cudaError_t err = ph - 1 > LOW_WHOLE ? launch<true>(a, B, s) : launch<false>(a, B, s);
  return static_cast<int>(err);
}
