// G2: sums of Montgomery products over a term axis, for sm_90a: the BEHZ
// tensor (mode 0) and relinearization's key-switch sum (mode 1).
//
// Replaces no Pallas kernel: the reference computes these inside its jitted
// XLA programs (apsu_tpu/core/bfv.py:63-85 _msum_tensor, :776-785 the
// tensor of tensor_scaledown_fused, :914-922 the digit products of
// relinearize), where XLA fuses the mont_mul chains (core/mod32.py:104).  The
// port widened each product to int64 and reduced the sum with
// torch.remainder.
//
// Mode 0: out[r] = sum_m (a0*b0, a0*b1 + a1*b0, a1*b1) with a = A[r][m],
// b = B[r][m] two-component NTT-Montgomery residues; mode 1: out[r][c] =
// sum_m A[m][r] * B[m][c] (digits times the key, the key read at limb
// b_last for the last limb: the special prime's column of a key generated
// above this level).  Every product is a canonical Montgomery product and
// every partial sum a canonical residue, so the result equals the plain
// version's int64 sum reduced once, bit for bit.
//
// Operands are addressed by strides, so the evaluator's broadcasts (the
// high powers over the caches of a bundle, the key over the batch) and
// its views cost no copy: output row r reads operand row
// ((r / div) % mod) * row, term m at m * m_stride, component 1 at comp,
// limb l at l * limb, lanes contiguous.
//
// What bounds it: bytes.  Mode 0 reads 4 words a term and writes 3 per
// (row, limb, lane), doing 4 Montgomery products (4 multiplies each) a
// term: 1 multiply a byte against the card's 5 (16.7 T multiplies/s over
// 3.35 TB/s).  One thread per (row, limb, lane) keeps its sums in
// registers; neighbouring threads read neighbouring lanes.
//
// The entry point allocates nothing, launches on the caller's stream and
// returns cudaGetLastError().

#include <cstring>

#include "behz.cuh"

using namespace behz;

namespace {

enum Mode { TENSOR = 0, KEYSWITCH = 1 };

struct Geom {
  long long div, mod, row, m, comp, limb;
};

__device__ __forceinline__ long long row_of(const Geom& g, long long r) {
  return ((r / g.div) % g.mod) * g.row;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
mont_mac_kernel(const uint32_t* __restrict__ a, const Geom ga, const uint32_t* __restrict__ b,
                const Geom gb, uint32_t* __restrict__ out, long long rows, int terms, int limbs,
                int n, int b_last, const ModTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const long long total = rows * limbs;
  for (long long rl = blockIdx.y; rl < total; rl += gridDim.y) {
    const long long r = rl / limbs;
    const int l = static_cast<int>(rl - r * limbs);
    uint32_t p = 0, pni = 0;
#pragma unroll
    for (int i = 0; i < MAXL; ++i) {
      if (i == l) {
        p = t.p[i];
        pni = t.pni[i];
      }
    }
    const int lb = l == limbs - 1 ? b_last : l;
    const uint32_t* pa = a + row_of(ga, r) + l * ga.limb + lane;
    const uint32_t* pb = b + row_of(gb, r) + lb * gb.limb + lane;
    if constexpr (MODE == TENSOR) {
      uint32_t c0 = 0, c1 = 0, c2 = 0;
      for (int m = 0; m < terms; ++m) {
        const uint32_t a0 = pa[m * ga.m], a1 = pa[m * ga.m + ga.comp];
        const uint32_t b0 = pb[m * gb.m], b1 = pb[m * gb.m + gb.comp];
        c0 = add_mod(c0, mont_mul(a0, b0, p, pni), p);
        c1 = add_mod(c1, add_mod(mont_mul(a0, b1, p, pni), mont_mul(a1, b0, p, pni), p), p);
        c2 = add_mod(c2, mont_mul(a1, b1, p, pni), p);
      }
      uint32_t* o = out + (r * 3 * limbs + l) * n + lane;
      o[0] = c0;
      o[limbs * n] = c1;
      o[2 * limbs * n] = c2;
    } else {
      uint32_t u0 = 0, u1 = 0;
      for (int m = 0; m < terms; ++m) {
        const uint32_t d = pa[m * ga.m];
        u0 = add_mod(u0, mont_mul(d, pb[m * gb.m], p, pni), p);
        u1 = add_mod(u1, mont_mul(d, pb[m * gb.m + gb.comp], p, pni), p);
      }
      uint32_t* o = out + (r * 2 * limbs + l) * n + lane;
      o[0] = u0;
      o[limbs * n] = u1;
    }
  }
}

}  // namespace

extern "C" int apsu_mont_mac(const void* a, long long a_div, long long a_mod, long long a_row,
                             long long a_m, long long a_comp, long long a_limb, const void* b,
                             long long b_div, long long b_mod, long long b_row, long long b_m,
                             long long b_comp, long long b_limb, void* out, long long rows,
                             int terms, int limbs, int n, int mode, int b_last,
                             const void* table, void* stream) {
  const bool ok = n > 0 && rows >= 0 && terms >= 0 && limbs >= 1 && limbs <= MAXL &&
                  a_div >= 1 && a_mod >= 1 && b_div >= 1 && b_mod >= 1 && b_last >= 0 &&
                  (mode == TENSOR || mode == KEYSWITCH);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  ModTable t;
  std::memcpy(&t, table, sizeof t);
  const Geom ga{a_div, a_mod, a_row, a_m, a_comp, a_limb};
  const Geom gb{b_div, b_mod, b_row, b_m, b_comp, b_limb};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const dim3 grid = grid_for(rows * limbs, n);
  if (mode == TENSOR) {
    mont_mac_kernel<TENSOR><<<grid, THREADS, 0, s>>>(pa, ga, pb, gb, o, rows, terms, limbs, n,
                                                      b_last, t);
  } else {
    mont_mac_kernel<KEYSWITCH><<<grid, THREADS, 0, s>>>(pa, ga, pb, gb, o, rows, terms, limbs,
                                                         n, b_last, t);
  }
  return static_cast<int>(cudaGetLastError());
}
