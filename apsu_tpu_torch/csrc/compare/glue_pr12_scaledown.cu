// Comparison source: G3's first design (../behz_scaledown.cu before the
// exact-count redesign), kept whole so that chip_smoke.py --compare-glue
// can time it in turns with the package's kernel.  It reads the fields of
// ../behz.cuh's tables that the first design had, which keep their offsets.
//
// G3: the BEHZ scale-down of a tensor product, for sm_90a: from the INTT'd
// tensor in q and in Bsk (Montgomery form) to round(t * x / Q) mod q, plain.
//
// Replaces no Pallas kernel: the reference computes this inside its jitted
// XLA programs (apsu_tpu/core/bfv.py:787-793, the from_mont of :63-85, over
// apsu_tpu/core/rns.py:129 BaseConv and :245 ShenoyKumaresanConv), where XLA
// fuses the u32 chains.  The port ran FastBConv and Shenoy-Kumaresan as
// Python loops over the limbs, one full-tensor Shoup product and modular add
// a limb.
//
// For one coefficient, with every residue in registers (core/rns.py:
// ScaleDown, whose table folds from_mont and t into the first constants):
//   y_i   = x_q,i * t * R^-1 * qhat_i^-1 mod q_i
//   xt_j  = x_b,j * t * R^-1 mod b_j
//   yb_j  = (xt_j - sum_i y_i * qhat_i) * Q^-1 mod b_j      (t/Q fast floor)
//   z_j   = yb_j * Bhat_j^-1 mod b_j, j < Lb - 1              (B = Bsk less m_sk)
//   alpha = (sum_j z_j * Bhat_j - yb_sk) * prod(B)^-1 mod m_sk, centred at
//           (m_sk + 1) / 2
//   out_i = sum_j z_j * Bhat_j -+ |alpha| * prod(B) mod q_i  (Shenoy-Kumaresan)
// Every step is a canonical residue, so the output equals the plain
// version's bit for bit.
//
// What bounds it: bytes and multiplies together.  A coefficient reads
// Lq + Lb words and writes Lq with about 2*Lq*Lb + 3*Lb + Lq Shoup products
// (three 32-bit multiplies each): at Lq = 4, Lb = 10, 72 bytes and about
// 400 multiplies, 5.6 a byte against the card's 5 (16.7 T multiplies/s over
// 3.35 TB/s).  One thread per (row, lane); neighbouring threads read
// neighbouring lanes; loops are unrolled to a bound (behz.cuh's SMALL_Q or
// MAXQ for q) so every register index and table word is a constant.
//
// Inputs: canonical residues, contiguous [rows][Lq][N] and [rows][Lb][N]
// (a row is one component of one ciphertext).  The entry point allocates
// nothing, launches on the caller's stream and returns cudaGetLastError().

#include <cstring>

#include "../behz.cuh"

using namespace behz;

namespace {

template <int QN, int BN>
__global__ void __launch_bounds__(THREADS)
behz_scaledown_kernel(const uint32_t* __restrict__ xq, const uint32_t* __restrict__ xb,
                      uint32_t* __restrict__ out, long long rows, int n, int lq, int lb,
                      const ScaleTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const int nb = lb - 1;   // B's limbs; m_sk is Bsk's last
  uint32_t msk = 0;
#pragma unroll
  for (int j = 0; j < BN; ++j)
    if (j == nb) msk = t.b[j];
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* pq = xq + r * lq * n + lane;
    const uint32_t* pb = xb + r * lb * n + lane;
    uint32_t y[QN];
#pragma unroll
    for (int i = 0; i < QN; ++i)
      if (i < lq) y[i] = shoup(pq[i * n], t.yq[i], t.yq_sh[i], t.q[i]);
    uint32_t z[BN];
    uint32_t ysk = 0;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      if (j < lb) {
        const uint32_t bj = t.b[j];
        const uint32_t xt = shoup(pb[j * n], t.xb[j], t.xb_sh[j], bj);
        uint32_t conv = 0;
#pragma unroll
        for (int i = 0; i < QN; ++i)
          if (i < lq) conv = add_mod(conv, shoup(y[i], t.m[i][j], t.m_sh[i][j], bj), bj);
        const uint32_t yb = shoup(sub_mod(xt, conv, bj), t.qinv[j], t.qinv_sh[j], bj);
        if (j < nb) {
          z[j] = shoup(yb, t.zb[j], t.zb_sh[j], bj);
        } else {
          ysk = yb;
        }
      }
    }
    uint32_t yhat_sk = 0;
#pragma unroll
    for (int j = 0; j < BN; ++j)
      if (j < nb) yhat_sk = add_mod(yhat_sk, shoup(z[j], t.msk_b[j], t.msk_b_sh[j], msk), msk);
    const uint32_t alpha = shoup(sub_mod(yhat_sk, ysk, msk), t.pbinv, t.pbinv_sh, msk);
    const bool neg = alpha >= t.msk_half;
    const uint32_t a_abs = neg ? msk - alpha : alpha;
    uint32_t* o = out + r * lq * n + lane;
#pragma unroll
    for (int i = 0; i < QN; ++i) {
      if (i < lq) {
        const uint32_t qi = t.q[i];
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < BN; ++j)
          if (j < nb) acc = add_mod(acc, shoup(z[j], t.mb[j][i], t.mb_sh[j][i], qi), qi);
        const uint32_t term = shoup(a_abs, t.pbq[i], t.pbq_sh[i], qi);
        o[i * n] = neg ? add_mod(acc, term, qi) : sub_mod(acc, term, qi);
      }
    }
  }
}

}  // namespace

extern "C" int apsu_behz_scaledown(const void* xq, const void* xb, void* out, long long rows,
                                   int n, int lq, int lb, const void* table, void* stream) {
  const bool ok = n > 0 && rows >= 0 && lq >= 1 && lq <= MAXQ && lb >= 2 && lb <= MAXB;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  ScaleTable t;
  std::memcpy(&t, table, sizeof t);
  auto run = [&](auto kernel) {
    kernel<<<grid_for(rows, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(xq), static_cast<const uint32_t*>(xb),
        static_cast<uint32_t*>(out), rows, n, lq, lb, t);
  };
  lq <= SMALL_Q ? run(behz_scaledown_kernel<SMALL_Q, MAXB>)
                : run(behz_scaledown_kernel<MAXQ, MAXB>);
  return static_cast<int>(cudaGetLastError());
}
