// G1: the exact BEHZ lift q -> Bsk with both Montgomery forms, for sm_90a;
// with one base's per-limb constant multiply (to_mont, from_mont) and
// relinearization's digits in Q*P as its two other modes.
//
// Replaces no Pallas kernel: the reference computes this inside its jitted
// XLA programs (apsu_tpu/core/bfv.py:753 operand_forms, :909-912 the digits
// of relinearize, over apsu_tpu/core/rns.py:165-243 ExactLiftConv), where
// XLA fuses the u32 chain into a few passes.  The port ran it as some forty
// eager int64 ops over the whole tensor.
//
// What bounds it: bytes.  A lift reads Lq residues of a coefficient and
// writes Lb (and Lq more when the q form is asked for); at 16M-4096's
// largest call (Lq = 4, Lb = 7, no q form) 44 bytes against 4 Shoup
// products, 35 widening products and 7 reductions.  One thread per
// coefficient lane keeps the column's residues in registers, neighbouring
// threads read neighbouring lanes, and the tables sit in the constant bank
// (kernel parameters).  The lift is built for every (Lq, Lb) of behz.cuh's
// BEHZ_EXACT_PAIRS with each loop exactly as long as its limb count (the
// first design's loops, csrc/compare/glue_pr12_lift.cu at f5d52af, were
// unrolled to the limits and guarded at run time), and once more for any
// other pair (the general build); a thread walks LIFT_ROWS_PER_BLOCK rows with the next
// row's loads in flight during the current row's arithmetic.  Digits and
// scale are built with their loops unrolled to behz.cuh's SMALL_Q or MAXQ
// and guarded by the run-time limb counts.
//
// Lift (mode 0), as rns.py's ExactLiftConv: c_i = [x_i * m~ * qhat_i^-1]_{q_i},
// the m~ = 2^16 correction r = [-(sum_i c_i * qhat_i) * Q^-1]_{m~} centred to
// [-2^15, 2^15), then for each Bsk limb (sum_i c_i * qhat_i +- |r| * Q) *
// m~^-1 * R as one lazy sum of widening products in a u64, the constants
// m~^-1 * R folded in (ma, k, kn), reduced once (behz.cuh's reduce64; every
// term is below 2^58 and a sum has at most 11, so none wraps).  The sum of
// 16-bit products that gives r wraps mod 2^32 exactly as the reference's
// uint32 does, and only its low 16 bits are read.  The q output (x * R mod
// q_i) is written when out_q is given.  Digits (mode 1): digit i of c2 (a
// residue < q_i, which may exceed a Q*P prime) times R in every Q*P limb,
// [digit][row][limb][N].  Scale (mode 2): x_j * a_j mod b_j.
//
// Inputs: canonical residues (any u32 for modes 1 and 2), lanes contiguous,
// limbs x_limb apart, rows where behz.cuh's Rows puts them (a view of two
// runs of leading axes is read in place).  Outputs are contiguous.  The
// entry point allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cstring>

#include "behz.cuh"

using namespace behz;

namespace {

enum Mode { LIFT = 0, DIGITS = 1, SCALE = 2 };

// rows a block of the lift walks, each row's loads in flight during the
// arithmetic of the row before it (one row a block ran slower in turns:
// csrc/compare/glue_step2_lift.cu at f5d52af, PERF.md section 6)
constexpr int LIFT_ROWS_PER_BLOCK = 4;

// digits and scale
template <int MODE, int QN, int BN>
__global__ void __launch_bounds__(THREADS)
behz_lift_kernel_digits_scale(const uint32_t* __restrict__ x, const Rows xw,
                              long long x_limb, uint32_t* __restrict__ out_b, long long rows,
                              int n, int lq, int lb, const LiftTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* xr = x + row_at(xw, r) + lane;
    if constexpr (MODE == SCALE) {
      uint32_t* o = out_b + r * lb * n + lane;
#pragma unroll
      for (int j = 0; j < BN; ++j)
        if (j < lb) o[j * n] = shoup(xr[j * x_limb], t.a[j], t.a_sh[j], t.b[j]);
    } else {
#pragma unroll
      for (int i = 0; i < QN; ++i) {
        if (i < lq) {
          const uint32_t d = xr[i * x_limb];
          uint32_t* o = out_b + ((i * rows + r) * lb) * n + lane;
#pragma unroll
          for (int j = 0; j < BN; ++j)
            if (j < lb) o[j * n] = shoup(d, t.a[j], t.a_sh[j], t.b[j]);
        }
      }
    }
  }
}

// the lift; QN, BN: the limb counts (EXACT) or the limits (general build,
// guarded by the run-time lq, lb).  An exact build loads a row's Lq words
// before the loop reaches the row, during the arithmetic of the row before
// (as G3's, behz_scaledown.cu); the general build at the top of each row.
template <int QN, int BN, bool EXACT>
__global__ void __launch_bounds__(THREADS)
behz_lift_kernel(const uint32_t* __restrict__ x, const Rows xw, long long x_limb,
                 uint32_t* __restrict__ out_q, uint32_t* __restrict__ out_b, long long rows,
                 int n, int lq_, int lb_, const LiftTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const int lq = EXACT ? QN : lq_, lb = EXACT ? BN : lb_;
  long long r = blockIdx.y;
  uint32_t nx[QN];   // the row's inputs, loaded ahead (EXACT)
  auto load = [&](long long row) {
    const uint32_t* xr = x + row_at(xw, row) + lane;
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < lq) nx[i] = xr[i * x_limb];
  };
  if (EXACT && r < rows) load(r);
  for (; r < rows; r += gridDim.y) {
    if (!EXACT) load(r);
    uint32_t c[QN];
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < lq) c[i] = nx[i];
    if (EXACT && r + gridDim.y < rows) load(r + gridDim.y);
    uint32_t c16 = 0;
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      if (i < lq) {
        if (out_q != nullptr)
          out_q[(r * lq + i) * n + lane] = shoup(c[i], t.qm[i], t.qm_sh[i], t.q[i]);
        c[i] = shoup(c[i], t.c[i], t.c_sh[i], t.q[i]);
        c16 += (c[i] & 0xFFFFu) * t.phat_mt[i];
      }
    }
    const uint32_t s = ((c16 & 0xFFFFu) * t.q_inv_mt) & 0xFFFFu;
    const uint32_t rr = (0x10000u - s) & 0xFFFFu;   // [-y * Q^-1] mod m~
    const bool neg = rr >= 0x8000u;
    const uint32_t r_abs = neg ? 0x10000u - rr : rr;
    uint32_t* o = out_b + r * lb * n + lane;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      if (j < lb) {
        uint64_t acc = mad_wide(r_abs, neg ? t.kn[j] : t.k[j], 0);
#pragma unroll
        for (int i = 0; i < QN; ++i)
          if (i < lq) acc = mad_wide(c[i], t.ma[i][j], acc);
        o[j * n] = reduce64(acc, t.b32[j], t.b32_sh[j], t.b_one_sh[j], t.b[j]);
      }
    }
  }
}

// the launch: the lift on the exact build of (lq, lb) when BEHZ_EXACT_PAIRS
// has it, else on the general one, LIFT_PER_BLOCK rows a block; digits and
// scale on their builds
template <int LIFT_PER_BLOCK>
int lift_launch(const void* x, long long x_inner, long long x_stride, long long x_outer,
                long long x_limb, void* out_q, void* out_b, long long rows, int n, int lq,
                int lb, int mode, const void* table, void* stream) {
  const bool ok = n > 0 && rows >= 0 && rows < (1LL << 31) && x_inner >= 1 &&
                  x_inner < (1LL << 31) && out_b != nullptr &&
                  ((mode == LIFT && lq >= 1 && lq <= MAXQ && lb >= 1 && lb <= MAXB) ||
                   (mode == DIGITS && lq >= 1 && lq <= MAXQ && lb >= 1 && lb <= MAXQ) ||
                   (mode == SCALE && lb >= 1 && lb <= MAXB && out_q == nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  LiftTable t;
  std::memcpy(&t, table, sizeof t);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* oq = static_cast<uint32_t*>(out_q);
  auto* ob = static_cast<uint32_t*>(out_b);
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  if (mode == LIFT) {
    auto run = [&](auto kernel) {
      kernel<<<grid_for(rows, n, LIFT_PER_BLOCK), THREADS, 0, s>>>(xi, xw, x_limb, oq, ob, rows,
                                                                   n, lq, lb, t);
    };
#define BEHZ_LIFT_CASE(Q, B)           \
  if (lq == Q && lb == B) {            \
    run(behz_lift_kernel<Q, B, true>); \
  } else
    BEHZ_EXACT_PAIRS(BEHZ_LIFT_CASE)
    run(behz_lift_kernel<MAXQ, MAXB, false>);
#undef BEHZ_LIFT_CASE
  } else {
    auto run = [&](auto kernel) {
      kernel<<<grid_for(rows, n), THREADS, 0, s>>>(xi, xw, x_limb, ob, rows, n, lq, lb, t);
    };
    if (mode == DIGITS) {
      lq <= SMALL_Q ? run(behz_lift_kernel_digits_scale<DIGITS, SMALL_Q, MAXB>)
                    : run(behz_lift_kernel_digits_scale<DIGITS, MAXQ, MAXQ>);
    } else {
      run(behz_lift_kernel_digits_scale<SCALE, MAXQ, MAXB>);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int apsu_behz_lift(const void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, void* out_q, void* out_b,
                              long long rows, int n, int lq, int lb, int mode,
                              const void* table, void* stream) {
  return lift_launch<LIFT_ROWS_PER_BLOCK>(x, x_inner, x_stride, x_outer, x_limb, out_q, out_b,
                                          rows, n, lq, lb, mode, table, stream);
}
