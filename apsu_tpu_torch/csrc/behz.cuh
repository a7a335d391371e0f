// Shared by the BFV/RNS glue kernels G1-G5 (behz_lift.cu, mont_mac.cu,
// behz_scaledown.cu, rns_divround.cu, scale_add.cu): modular arithmetic on
// canonical u32 residues of primes p < 2^30, the constant tables the
// wrappers fill on the host (apsu_tpu_torch/core/rns.py, the same field
// order and sizes), and the launch shape.
//
// A table is passed to its kernel BY VALUE, so it sits in the kernel's
// parameter space: every thread reads the same word through the constant
// cache, nothing is allocated, and a launch captured into a CUDA graph keeps
// its own copy.  The largest (ScaleTable) is 3,444 bytes.  The limits below
// cover every parameter set of the repository and its tests (at most 9 q
// limbs, 10 Q*P limbs and 12 Bsk limbs).  They are kept that tight: with
// tables and loops sized for 12 q and 16 Bsk limbs, G2 and G3 ran 29% and
// 45% slower at 16M-4096's shapes than at 8 and 12 (PERF.md, section 6).
//
// G3 and G1's lift are built once for each (Lq, Lb) pair of BEHZ_EXACT_PAIRS,
// with every loop of exactly its length, and once more for any other pair
// within MAXQ / MAXB (the general build, loops to the limits guarded by the
// run-time counts).  The list is every (q limbs, Bsk limbs) pair that a
// parameter file of the repository reaches at any level, with the Bsk base
// of a multiply and of any multiply-sum (tests/test_torch_behz.py holds it
// to that).  G1's other modes and G4 are built with their q loops unrolled
// to SMALL_Q = 8, which every parameter set's q (7) and Q*P (8) limbs fit,
// and to MAXQ, and a launch takes the first when its limb counts fit: the
// first design's G1, G3 and G4 each read 5-9% faster that way than on one
// build at MAXQ over the 16M-4096 warm query's calls
// (csrc/compare/glue_max_*.cu at f5d52af, PERF.md section 6).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace behz {

constexpr int MAXQ = 10;   // q limbs (with the special prime: Q*P limbs)
constexpr int MAXB = 12;   // Bsk limbs, m_sk included
constexpr int MAXL = 12;   // limbs of any one base
constexpr int SMALL_Q = 8;  // the second build's q (Q*P) loops (G1's digits, G4)
constexpr int THREADS = 128;
constexpr unsigned MAX_GRID_Y = 65535;

// (Lq, Lb) of the exact builds of G3 and G1's lift: X(q limbs, Bsk limbs)
#define BEHZ_EXACT_PAIRS(X) \
  X(1, 4) X(2, 4) X(2, 5) X(3, 5) X(3, 6) X(4, 6) X(4, 7) X(5, 7) X(5, 8) X(6, 9) X(7, 10)

// Where row r of an operand's flattened leading axes starts:
// (r / inner) * outer + (r % inner) * stride.  Leading axes that form at
// most two runs of uniform stride are read in place this way, such as a
// slice of a middle axis (the PS evaluation's inner[:, 1:]); rows < 2^31.
struct Rows {
  unsigned inner;
  long long stride, outer;
};

__device__ __forceinline__ long long row_at(const Rows& w, long long r) {
  const unsigned q = static_cast<unsigned>(r) / w.inner;
  return q * w.outer + (static_cast<unsigned>(r) - q * w.inner) * w.stride;
}

// x*c mod p, canonical, for any 32-bit x and a constant c < p with its
// Shoup companion c_sh = floor(c * 2^32 / p): x*c - hi(x*c_sh)*p lies in
// [0, 2p), exact in 32 bits since 2p < 2^32.
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t c, uint32_t c_sh, uint32_t p) {
  const uint32_t t = x * c - __umulhi(x, c_sh) * p;
  return t >= p ? t - p : t;
}

// a * b + c for u32 a, b and u64 c: one IMAD.WIDE.U32 (written in C++,
// ptxas adds an instruction for the zero high word; csrc/ps_inner.cu)
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

// s mod p, canonical, for any 64-bit s: s = hi * 2^32 + lo, and each half
// goes through one Shoup product, hi by c32 = 2^32 mod p (c32_sh its
// companion) and lo by 1 (one_sh = floor(2^32 / p)).  This is how the lazy
// sums of G3 and the lift (a u64 of widening products) become residues.
__device__ __forceinline__ uint32_t reduce64(uint64_t s, uint32_t c32, uint32_t c32_sh,
                                             uint32_t one_sh, uint32_t p) {
  const uint32_t hi = static_cast<uint32_t>(s >> 32), lo = static_cast<uint32_t>(s);
  const uint32_t a = hi * c32 - __umulhi(hi, c32_sh) * p;   // [0, 2p)
  const uint32_t b = lo - __umulhi(lo, one_sh) * p;          // [0, 2p)
  const uint32_t a1 = min(a, a - p), b1 = min(b, b - p);
  const uint32_t t = a1 + b1;
  return min(t, t - p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

// Montgomery product a*b*2^-32 mod p for a, b < p < 2^31, canonical: PTX's
// multiprecision pair takes hi(m*p + a*b) with the low words' carry in one
// IMAD.HI (csrc/roofline.cu:mont_step, where the SASS is counted).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p, uint32_t pni) {
  uint32_t r;
  asm("{\n\t"
      ".reg .u64 w;\n\t"
      ".reg .u32 lo, hi, m, t, u, z;\n\t"
      "mul.wide.u32 w, %1, %2;\n\t"
      "mov.b64 {lo, hi}, w;\n\t"
      "mul.lo.u32 m, lo, %4;\n\t"
      "mad.lo.cc.u32 z, m, %3, lo;\n\t"
      "madc.hi.u32 t, m, %3, hi;\n\t"
      "sub.u32 u, t, %3;\n\t"
      "min.u32 %0, t, u;\n\t"
      "}"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(p), "r"(pni));
  return r;
}

// G1: one base's per-limb constant multiply (q, qm), and the m~-corrected
// lift q -> Bsk with Bsk's Montgomery factor folded in (core/rns.py:
// ExactLiftConv.table, RnsBase.to_mont_table / from_mont_table)
struct LiftTable {
  uint32_t q[MAXQ];
  uint32_t qm[MAXQ], qm_sh[MAXQ];        // the q output's constant (R or R^-1 mod q_i)
  uint32_t c[MAXQ], c_sh[MAXQ];          // m~ * qhat_i^-1 mod q_i
  uint32_t phat_mt[MAXQ];                // qhat_i mod 2^16
  uint32_t q_inv_mt;                     // Q^-1 mod 2^16
  uint32_t b[MAXB];
  uint32_t m[MAXQ][MAXB], m_sh[MAXQ][MAXB];   // qhat_i mod b_j
  uint32_t a[MAXB], a_sh[MAXB];          // m~^-1 * R mod b_j
  uint32_t k[MAXB], k_sh[MAXB];          // Q * m~^-1 * R mod b_j
  // appended for the lift's lazy sums (csrc/behz_lift.cu); the fields above
  // keep their offsets for the first design (csrc/compare/glue_pr12_*.cu at
  // f5d52af)
  uint32_t ma[MAXQ][MAXB];               // qhat_i * m~^-1 * R mod b_j
  uint32_t kn[MAXB];                     // -Q * m~^-1 * R mod b_j
  uint32_t b32[MAXB], b32_sh[MAXB], b_one_sh[MAXB];   // reduce64's constants of b_j
};

// G2: a base's primes and -p^-1 mod 2^32 (RnsBase.mod_table)
struct ModTable {
  uint32_t p[MAXL], pni[MAXL];
};

// G3: the t/Q fast floor in Bsk and Shenoy-Kumaresan back to q, Montgomery
// inputs (core/rns.py: ScaleDown.table)
struct ScaleTable {
  uint32_t q[MAXQ];
  uint32_t yq[MAXQ], yq_sh[MAXQ];        // t * R^-1 * qhat_i^-1 mod q_i
  uint32_t b[MAXB];
  uint32_t xb[MAXB], xb_sh[MAXB];        // t * R^-1 mod b_j
  uint32_t m[MAXQ][MAXB], m_sh[MAXQ][MAXB];   // qhat_i mod b_j
  uint32_t qinv[MAXB], qinv_sh[MAXB];    // Q^-1 mod b_j
  uint32_t zb[MAXB], zb_sh[MAXB];        // Bhat_j^-1 mod b_j (B = Bsk less m_sk)
  uint32_t mb[MAXB][MAXQ], mb_sh[MAXB][MAXQ];  // Bhat_j mod q_i
  uint32_t msk_b[MAXB], msk_b_sh[MAXB];  // Bhat_j mod m_sk
  uint32_t pbinv, pbinv_sh;              // prod(B)^-1 mod m_sk
  uint32_t msk_half;                     // (m_sk + 1) / 2
  uint32_t pbq[MAXQ], pbq_sh[MAXQ];      // prod(B) mod q_i
  // appended for G3's lazy sums (csrc/behz_scaledown.cu); the fields above
  // keep their offsets for the first design (csrc/compare/glue_pr12_*.cu at
  // f5d52af).
  // w_j is z_j for j < Lb - 1 and y_sk for m_sk.
  uint32_t wx[MAXB];                     // t * R^-1 * Q^-1 (* Bhat_j^-1) mod b_j
  uint32_t wy[MAXQ][MAXB];               // -qhat_i * Q^-1 (* Bhat_j^-1) mod b_j
  uint32_t ak[MAXB];                     // Bhat_j * prod(B)^-1 mod m_sk; -prod(B)^-1 for m_sk
  uint32_t npbq[MAXQ];                   // -prod(B) mod q_i
  uint32_t q32[MAXQ], q32_sh[MAXQ], q_one_sh[MAXQ];   // reduce64's constants of q_i
  uint32_t b32[MAXB], b32_sh[MAXB], b_one_sh[MAXB];   // and of b_j
};

// G4: rounded exact division by the chain's own limbs, the top one first
// (core/rns.py: ExactDiv.table); [d][j] is divisor limb d's constant mod q_j
struct DivTable {
  uint32_t q[MAXQ];
  uint32_t rinv[MAXQ], rinv_sh[MAXQ];    // R^-1 mod q_j
  uint32_t one_sh[MAXQ];                 // floor(2^32 / q_j): any x < 2^32 mod q_j
  uint32_t half[MAXQ];                   // q_d >> 1
  uint32_t half_q[MAXQ][MAXQ];           // (q_d >> 1) mod q_j
  uint32_t dinv[MAXQ][MAXQ], dinv_sh[MAXQ][MAXQ];   // q_d^-1 mod q_j
};

// G5: BFV's plaintext scaling round(Q*m/t) mod q_j at one level and the adds
// around it (core/rns.py: DeltaScale.table)
struct DeltaTable {
  uint32_t q[MAXQ];
  uint32_t t, rt, rt_sh, h;              // t; Q mod t and its Shoup companion mod t; t >> 1
  uint32_t hq[MAXQ];                     // (t >> 1) mod q_j
  uint32_t tinv[MAXQ], tinv_sh[MAXQ];    // t^-1 mod q_j
  uint32_t r1[MAXQ], r1_sh[MAXQ];        // R mod q_j (the Montgomery form)
};

static_assert(sizeof(LiftTable) == 529 * 4, "LiftTable layout");
static_assert(sizeof(ModTable) == 24 * 4, "ModTable layout");
static_assert(sizeof(ScaleTable) == 861 * 4, "ScaleTable layout");
static_assert(sizeof(DivTable) == 350 * 4, "DivTable layout");
static_assert(sizeof(DeltaTable) == 64 * 4, "DeltaTable layout");

// blocks of THREADS lanes along N (x), each walking ``per_block`` rows of
// the flattened leading axes (y), more when there are more rows than a
// grid's y
inline dim3 grid_for(long long rows, int n, int per_block = 1) {
  const long long want = (rows + per_block - 1) / per_block;
  const unsigned y = want < MAX_GRID_Y ? static_cast<unsigned>(want) : MAX_GRID_Y;
  return dim3(static_cast<unsigned>((n + THREADS - 1) / THREADS), y);
}

}  // namespace behz
