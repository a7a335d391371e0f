// G3: the BEHZ scale-down of a tensor product, for sm_90a: from the INTT'd
// tensor in q and in Bsk (Montgomery form) to round(t * x / Q) mod q, plain.
//
// Replaces no Pallas kernel: the reference computes this inside its jitted
// XLA programs (apsu_tpu/core/bfv.py:787-793, the from_mont of :63-85, over
// apsu_tpu/core/rns.py:129 BaseConv and :245 ShenoyKumaresanConv), where XLA
// fuses the u32 chains.
//
// For one coefficient, with every residue in registers (core/rns.py:
// ScaleDown, whose table folds from_mont, t, Q^-1, Bhat_j^-1 and
// prod(B)^-1 into the constants of each sum):
//   y_i   = x_q,i * t * R^-1 * qhat_i^-1 mod q_i                  (Shoup)
//   w_j   = x_b,j * wx_j + sum_i y_i * wy_ij mod b_j   (one lazy sum a limb)
//           = z_j = yb_j * Bhat_j^-1 for j < Lb - 1, with
//             yb_j = (t * x_b,j - sum_i y_i * qhat_i) * Q^-1 the t/Q fast
//             floor, and = yb_sk for m_sk (B = Bsk less m_sk)
//   alpha = sum_j<Lb-1 z_j * Bhat_j * prod(B)^-1 - yb_sk * prod(B)^-1 mod m_sk,
//           centred at (m_sk + 1) / 2
//   out_i = sum_j z_j * Bhat_j -+ |alpha| * prod(B) mod q_i  (Shenoy-Kumaresan)
// Each sum gathers widening products (behz.cuh's mad_wide, one
// IMAD.WIDE.U32) in a u64 and is reduced once to a canonical residue
// (reduce64).  Every term is below 2^58 (a residue < 2^30 times one < 2^28),
// and no sum has more than 12, so none wraps (tests/test_torch_behz.py
// checks every parameter file's worst case).  Every value that leaves a sum
// is canonical, so the output equals the plain version's bit for bit.
//
// What bounds it: bytes and multiplies together.  A coefficient reads
// Lq + Lb words and writes Lq; at 16M-4096's largest call (Lq = 6, Lb = 9)
// 84 bytes against 126 widening products, 16 reductions and 6 Shoup
// products.  The kernel is built for every (Lq, Lb) of behz.cuh's
// BEHZ_EXACT_PAIRS, with each loop exactly as long as its limb count (the
// first design's loops, csrc/compare/glue_pr12_scaledown.cu at f5d52af,
// unrolled to the limits and guarded at run time, spent slots on every
// guarded-off iteration), and once more for any other pair (the general build).  One
// thread per (row, lane); neighbouring threads read neighbouring lanes; a
// block takes one row (ROWS_PER_BLOCK), all of whose loads are in flight
// before its arithmetic.
//
// Inputs: canonical residues, contiguous [rows][Lq][N] and [rows][Lb][N]
// (a row is one component of one ciphertext).  The entry point allocates
// nothing, launches on the caller's stream and returns cudaGetLastError().

#include <cstring>

#include "behz.cuh"

using namespace behz;

namespace {

// rows a block walks: 1, so a block takes one row unless there are more
// rows than a grid's y (4 ran slower in turns:
// csrc/compare/glue_rows4_scaledown.cu at f5d52af, PERF.md section 6)
constexpr int ROWS_PER_BLOCK = 1;

// QN, BN: the limb counts (EXACT) or the limits (general build, guarded by
// the run-time lq, lb).  An exact build loads a row's Lq + Lb words before
// the loop reaches the row, so all of them are in flight before its
// arithmetic, and with more than one row a block, during the arithmetic of
// the row before (loaded at the top of the row, the exact builds had fewer
// instructions and ran slower, PERF.md section 6).  The general build loads
// at the top of each row (ahead, it spilled).
template <int QN, int BN, bool EXACT>
__global__ void __launch_bounds__(THREADS)
behz_scaledown_kernel(const uint32_t* __restrict__ xq, const uint32_t* __restrict__ xb,
                      uint32_t* __restrict__ out, long long rows, int n, int lq_, int lb_,
                      const ScaleTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const int lq = EXACT ? QN : lq_, lb = EXACT ? BN : lb_;
  const int nb = lb - 1;   // B's limbs; m_sk is Bsk's last
  uint32_t msk = 0, m32 = 0, m32_sh = 0, m_one_sh = 0;
#pragma unroll
  for (int j = 0; j < BN; ++j)
    if (j == nb) {
      msk = t.b[j];
      m32 = t.b32[j];
      m32_sh = t.b32_sh[j];
      m_one_sh = t.b_one_sh[j];
    }
  long long r = blockIdx.y;
  uint32_t nq[QN], nbv[BN];   // the row's inputs, loaded ahead (EXACT)
  auto load = [&](long long row) {
    const uint32_t* pq = xq + row * lq * n + lane;
    const uint32_t* pb = xb + row * lb * n + lane;
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < lq) nq[i] = pq[i * n];
#pragma unroll
    for (int j = 0; j < BN; ++j)
      if (j < lb) nbv[j] = pb[j * n];
  };
  if (EXACT && r < rows) load(r);
  for (; r < rows; r += gridDim.y) {
    if (!EXACT) load(r);
    uint32_t y[QN], vb[BN];
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < lq) y[i] = nq[i];
#pragma unroll
    for (int j = 0; j < BN; ++j)
      if (j < lb) vb[j] = nbv[j];
    if (EXACT && r + gridDim.y < rows) load(r + gridDim.y);
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < lq) y[i] = shoup(y[i], t.yq[i], t.yq_sh[i], t.q[i]);
    uint32_t w[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      if (j < lb) {
        uint64_t s = mad_wide(vb[j], t.wx[j], 0);
#pragma unroll
        for (int i = 0; i < QN; ++i)
          if (i < lq) s = mad_wide(y[i], t.wy[i][j], s);
        w[j] = reduce64(s, t.b32[j], t.b32_sh[j], t.b_one_sh[j], t.b[j]);
      }
    }
    uint64_t sa = 0;
#pragma unroll
    for (int j = 0; j < BN; ++j)
      if (j < lb) sa = mad_wide(w[j], t.ak[j], sa);
    const uint32_t alpha = reduce64(sa, m32, m32_sh, m_one_sh, msk);
    const bool neg = alpha >= t.msk_half;
    const uint32_t a_abs = neg ? msk - alpha : alpha;
    uint32_t* o = out + r * lq * n + lane;
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      if (i < lq) {
        uint64_t s = mad_wide(a_abs, neg ? t.pbq[i] : t.npbq[i], 0);
#pragma unroll
        for (int j = 0; j < BN; ++j)
          if (j < nb) s = mad_wide(w[j], t.mb[j][i], s);
        o[i * n] = reduce64(s, t.q32[i], t.q32_sh[i], t.q_one_sh[i], t.q[i]);
      }
    }
  }
}

// the launch: the exact build of (lq, lb) when BEHZ_EXACT_PAIRS has it,
// else the general one; PER_BLOCK rows a block
template <int PER_BLOCK>
int scaledown_launch(const void* xq, const void* xb, void* out, long long rows, int n, int lq,
                     int lb, const void* table, void* stream) {
  const bool ok = n > 0 && rows >= 0 && lq >= 1 && lq <= MAXQ && lb >= 2 && lb <= MAXB;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  ScaleTable t;
  std::memcpy(&t, table, sizeof t);
  auto run = [&](auto kernel) {
    kernel<<<grid_for(rows, n, PER_BLOCK), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(xq), static_cast<const uint32_t*>(xb),
        static_cast<uint32_t*>(out), rows, n, lq, lb, t);
  };
#define BEHZ_SCALEDOWN_CASE(Q, B)           \
  if (lq == Q && lb == B) {                 \
    run(behz_scaledown_kernel<Q, B, true>); \
  } else
  BEHZ_EXACT_PAIRS(BEHZ_SCALEDOWN_CASE)
  run(behz_scaledown_kernel<MAXQ, MAXB, false>);
#undef BEHZ_SCALEDOWN_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int apsu_behz_scaledown(const void* xq, const void* xb, void* out, long long rows,
                                   int n, int lq, int lb, const void* table, void* stream) {
  return scaledown_launch<ROWS_PER_BLOCK>(xq, xb, out, rows, n, lq, lb, table, stream);
}
