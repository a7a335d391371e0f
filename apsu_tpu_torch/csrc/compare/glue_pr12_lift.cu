// Comparison source: G1's first design (../behz_lift.cu before the
// exact-count redesign), kept whole so that chip_smoke.py --compare-glue
// can time it in turns with the package's kernel.  It reads the fields of
// ../behz.cuh's tables that the first design had, which keep their offsets.
//
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
// writes Lq + Lb (Lq <= 7, Lb <= 10 on every parameter set) with
// Lq*(Lb + 2) + 2*Lb Shoup products of three 32-bit multiplies each: at
// Lq = 4, Lb = 10, 72 bytes and 204 multiplies, 2.8 a byte against the
// card's 5 (16.7 T multiplies/s over 3.35 TB/s).  One thread per
// coefficient lane keeps the column's residues in registers (every loop is
// unrolled to a bound, behz.cuh's SMALL_Q or MAXQ for q, and guarded by the
// run-time limb counts, so every index is a constant), neighbouring
// threads read neighbouring lanes, and the tables sit in the constant bank
// (kernel parameters).
//
// Lift (mode 0), as rns.py's ExactLiftConv: c_i = [x_i * m~ * qhat_i^-1]_{q_i},
// the m~ = 2^16 correction r = [-(sum_i c_i * qhat_i) * Q^-1]_{m~} centred to
// [-2^15, 2^15), then for each Bsk limb (sum_i c_i * qhat_i +- |r| * Q) *
// m~^-1, with Bsk's R folded into the last two constants; the sum of 16-bit
// products wraps mod 2^32 exactly as the reference's uint32 does, and only
// its low 16 bits are read.  The q output (x * R mod q_i) is written when
// out_q is given.  Digits (mode 1): digit i of c2 (a residue < q_i, which
// may exceed a Q*P prime) times R in every Q*P limb, [digit][row][limb][N].
// Scale (mode 2): x_j * a_j mod b_j.
//
// Inputs: canonical residues (any u32 for modes 1 and 2), lanes contiguous,
// limbs x_limb apart, rows where behz.cuh's Rows puts them (a view of two
// runs of leading axes is read in place).  Outputs are contiguous.  The
// entry point allocates nothing, launches on the caller's stream and returns
// cudaGetLastError().

#include <cstring>

#include "../behz.cuh"

using namespace behz;

namespace {

enum Mode { LIFT = 0, DIGITS = 1, SCALE = 2 };

template <int MODE, int QN, int BN>
__global__ void __launch_bounds__(THREADS)
behz_lift_kernel(const uint32_t* __restrict__ x, const Rows xw, long long x_limb,
                 uint32_t* __restrict__ out_q, uint32_t* __restrict__ out_b, long long rows,
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
    } else if constexpr (MODE == DIGITS) {
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
    } else {
      uint32_t c[QN];
      uint32_t c16 = 0;
#pragma unroll
      for (int i = 0; i < QN; ++i) {
        if (i < lq) {
          const uint32_t xi = xr[i * x_limb];
          if (out_q != nullptr)
            out_q[(r * lq + i) * n + lane] = shoup(xi, t.qm[i], t.qm_sh[i], t.q[i]);
          c[i] = shoup(xi, t.c[i], t.c_sh[i], t.q[i]);
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
          const uint32_t bj = t.b[j];
          uint32_t acc = 0;
#pragma unroll
          for (int i = 0; i < QN; ++i)
            if (i < lq) acc = add_mod(acc, shoup(c[i], t.m[i][j], t.m_sh[i][j], bj), bj);
          const uint32_t a1 = shoup(acc, t.a[j], t.a_sh[j], bj);
          const uint32_t corr = shoup(r_abs, t.k[j], t.k_sh[j], bj);
          o[j * n] = neg ? sub_mod(a1, corr, bj) : add_mod(a1, corr, bj);
        }
      }
    }
  }
}

}  // namespace

extern "C" int apsu_behz_lift(const void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, void* out_q, void* out_b,
                              long long rows, int n, int lq, int lb, int mode,
                              const void* table, void* stream) {
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
  const dim3 grid = grid_for(rows, n);
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  auto run = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(xi, xw, x_limb, oq, ob, rows, n, lq, lb, t);
  };
  const bool small = lq <= SMALL_Q;
  if (mode == LIFT) {
    small ? run(behz_lift_kernel<LIFT, SMALL_Q, MAXB>)
          : run(behz_lift_kernel<LIFT, MAXQ, MAXB>);
  } else if (mode == DIGITS) {
    small ? run(behz_lift_kernel<DIGITS, SMALL_Q, MAXB>)
          : run(behz_lift_kernel<DIGITS, MAXQ, MAXQ>);
  } else {
    run(behz_lift_kernel<SCALE, MAXQ, MAXB>);
  }
  return static_cast<int>(cudaGetLastError());
}
