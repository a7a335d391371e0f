// G4: rounded exact division of an RNS integer by its own top limbs, for
// sm_90a: relinearization's mod-down by the special prime P (mode 0) and
// the mod-switch from level top down to level target (mode 1).
//
// Replaces no Pallas kernel: the reference computes these inside its jitted
// XLA programs (apsu_tpu/core/bfv.py:923-926 and :931-945 over
// apsu_tpu/core/rns.py:295 ExactDiv), where XLA fuses the u32 chains.  The
// port ran each drop as some twenty eager int64 ops over the tensor.
//
// One drop of limb d (a step of core/rns.py:ExactDiv with its +d/2
// rounding), for every lower limb j:
//   x_j <- ((x_j + (q_d >> 1)) - ((x_d + (q_d >> 1)) mod q_d) mod q_j) * q_d^-1
// all mod q_j, each value canonical.  Mode 1 keeps a coefficient's limbs in
// registers and drops top - 1, top - 2, ..., target in turn, each drop
// reading the limb as the drops before left it: the same rounding at each
// step as the sequential drops, bit for bit.  Mode 0 first leaves
// Montgomery form (the key-switch sum comes from the INTT), drops P (limb
// top - 1) and adds the ciphertext's component: out = c_k + u_k / P.
//
// What bounds it: bytes.  A coefficient reads top words (mode 0: and top-1
// of c) and writes target, with about 3 Shoup products a limb and drop.
// One thread per (row, lane); neighbouring threads read neighbouring lanes;
// loops are unrolled to a bound (behz.cuh's SMALL_Q or MAXQ) so every index
// is a constant.
//
// Inputs: canonical residues, lanes contiguous, limbs n apart, rows where
// behz.cuh's Rows puts them (mode 0: row 2r + k of x is component k of
// ciphertext row r, whose c row is at c_rows' r, component k c_comp
// further).  The output is contiguous.  The entry point allocates nothing,
// launches on the caller's stream and returns cudaGetLastError().

#include <cstring>

#include "behz.cuh"

using namespace behz;

namespace {

enum Mode { KEYSWITCH = 0, MODSWITCH = 1 };

template <int MODE, int QN>
__global__ void __launch_bounds__(THREADS)
rns_divround_kernel(const uint32_t* __restrict__ x, const Rows xw,
                    const uint32_t* __restrict__ c, const Rows cw, long long c_comp,
                    uint32_t* __restrict__ out, long long rows, int n, int top, int target,
                    const DivTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* px = x + row_at(xw, r) + lane;
    uint32_t v[QN];
#pragma unroll
    for (int j = 0; j < QN; ++j) {
      if (j < top) {
        v[j] = px[j * n];
        if constexpr (MODE == KEYSWITCH) v[j] = shoup(v[j], t.rinv[j], t.rinv_sh[j], t.q[j]);
      }
    }
#pragma unroll
    for (int d = QN - 1; d >= 1; --d) {
      if (d < top && d >= target) {
        const uint32_t qd = t.q[d];
        uint32_t s = v[d] + t.half[d];
        s = s >= qd ? s - qd : s;
#pragma unroll
        for (int j = 0; j < QN - 1; ++j) {
          if (j < d) {
            const uint32_t qj = t.q[j];
            const uint32_t a = add_mod(v[j], t.half_q[d][j], qj);
            const uint32_t sd = shoup(s, 1u, t.one_sh[j], qj);
            v[j] = shoup(sub_mod(a, sd, qj), t.dinv[d][j], t.dinv_sh[d][j], qj);
          }
        }
      }
    }
    if constexpr (MODE == KEYSWITCH) {
      const uint32_t* pc = c + row_at(cw, r >> 1) + (r & 1) * c_comp + lane;
      uint32_t* o = out + r * target * n + lane;
#pragma unroll
      for (int j = 0; j < QN; ++j)
        if (j < target) o[j * n] = add_mod(pc[j * n], v[j], t.q[j]);
    } else {
      uint32_t* o = out + r * target * n + lane;
#pragma unroll
      for (int j = 0; j < QN; ++j)
        if (j < target) o[j * n] = v[j];
    }
  }
}

}  // namespace

extern "C" int apsu_rns_divround(const void* x, long long x_inner, long long x_stride,
                                 long long x_outer, const void* c, long long c_inner,
                                 long long c_stride, long long c_outer, long long c_comp,
                                 void* out, long long rows, int n, int top, int target, int mode,
                                 const void* table, void* stream) {
  const bool ok = n > 0 && rows >= 0 && rows < (1LL << 31) && x_inner >= 1 &&
                  x_inner < (1LL << 31) && c_inner >= 1 && c_inner < (1LL << 31) && top >= 2 &&
                  top <= MAXQ && target >= 1 && target < top &&
                  ((mode == KEYSWITCH && target == top - 1 && c != nullptr) ||
                   mode == MODSWITCH);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  DivTable t;
  std::memcpy(&t, table, sizeof t);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* px = static_cast<const uint32_t*>(x);
  const auto* pc = static_cast<const uint32_t*>(c);
  auto* o = static_cast<uint32_t*>(out);
  const dim3 grid = grid_for(rows, n);
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  const Rows cw{static_cast<unsigned>(c_inner), c_stride, c_outer};
  auto run = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(px, xw, pc, cw, c_comp, o, rows, n, top, target, t);
  };
  const bool small = top <= SMALL_Q;
  if (mode == KEYSWITCH) {
    small ? run(rns_divround_kernel<KEYSWITCH, SMALL_Q>)
          : run(rns_divround_kernel<KEYSWITCH, MAXQ>);
  } else {
    small ? run(rns_divround_kernel<MODSWITCH, SMALL_Q>)
          : run(rns_divround_kernel<MODSWITCH, MAXQ>);
  }
  return static_cast<int>(cudaGetLastError());
}
