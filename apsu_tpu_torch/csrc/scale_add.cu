// G5: BFV's plaintext scaling Delta*m = round(Q*m/t) mod q_j and the
// residue adds that fold it into a ciphertext, for sm_90a: the scaling alone
// (mode 0), the scaling added in place into a ciphertext's component with
// its Montgomery form written beside it (mode 1), and a plain in-place add
// of two residue tensors (mode 2).
//
// Replaces no Pallas kernel: the reference computes these inside its jitted
// XLA programs (apsu_tpu/core/bfv.py:646 _scale_impl; the PS evaluation's
// constant term and mask, apsu_tpu/engine/evaluator.py:941-972), where XLA
// fuses the u32 chains.  The port ran the PS evaluation's constant term as
// some seventy eager int64 ops, most of them over the whole [rows, L, N]
// extent.
//
// The scaling of a coefficient m < t, as core/bfv.py:_scale_impl (exact in
// RNS since Q = 0 mod q_j):
//   rem = (r*m + h) mod t,  r = Q mod t, h = t >> 1;
//   Delta*m mod q_j = ((h mod q_j) - rem) * t^-1 mod q_j,
// with r*m mod t and the product by t^-1 as Shoup products: m is read once
// and every limb's value is made in registers.  Mode 1 adds it into x's row
// and, when out is given, writes its Montgomery form (times R mod q_j) for
// the rows r with r mod period >= skip, packed in their order: the PS
// evaluation's constant planes 1..nh, the input of kernel 1's forward
// transform.  Mode 2 adds y's row into x's.
//
// What bounds it: bytes.  Mode 1 reads a coefficient's m and its L limbs of
// x and writes L limbs of x and of out, with 2 + 2L Shoup products; mode 2
// reads 2L words and writes L.  One thread per (row, lane); neighbouring
// threads read neighbouring lanes; the limb loop is unrolled to a bound
// (behz.cuh's SMALL_Q or MAXQ) so every index is a constant.
//
// Inputs: canonical residues (m < t), lanes contiguous, limbs x_limb and
// y_limb apart, rows where behz.cuh's Rows puts them; x, written in place,
// overlaps neither m nor y.  out is contiguous.  The entry point allocates
// nothing, launches on the caller's stream and returns cudaGetLastError().

#include <cstring>

#include "behz.cuh"

using namespace behz;

namespace {

enum Mode { SCALE = 0, SCALE_ADD = 1, ADD = 2 };

template <int MODE, int QN>
__global__ void __launch_bounds__(THREADS)
scale_add_kernel(const uint32_t* __restrict__ m, const Rows mw, uint32_t* __restrict__ x,
                 const Rows xw, long long x_limb, const uint32_t* __restrict__ y,
                 const Rows yw, long long y_limb, uint32_t* __restrict__ out, int period,
                 int skip, long long rows, int n, int lq, const DeltaTable t) {
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    if constexpr (MODE == ADD) {
      uint32_t* px = x + row_at(xw, r) + lane;
      const uint32_t* py = y + row_at(yw, r) + lane;
#pragma unroll
      for (int j = 0; j < QN; ++j)
        if (j < lq) px[j * x_limb] = add_mod(px[j * x_limb], py[j * y_limb], t.q[j]);
    } else {
      const uint32_t rm = shoup(m[row_at(mw, r) + lane], t.rt, t.rt_sh, t.t);
      const uint32_t rem = add_mod(rm, t.h, t.t);   // < t < q_j
      uint32_t* o = nullptr;
      if constexpr (MODE == SCALE) {
        o = out + r * lq * n + lane;
      } else if (out != nullptr) {
        const unsigned u = static_cast<unsigned>(r), p = period, k = u % p;
        if (k >= static_cast<unsigned>(skip))
          o = out + (static_cast<long long>(u / p) * (p - skip) + k - skip) * lq * n + lane;
      }
      uint32_t* px = MODE == SCALE_ADD ? x + row_at(xw, r) + lane : nullptr;
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        if (j < lq) {
          const uint32_t qj = t.q[j];
          const uint32_t v = shoup(sub_mod(t.hq[j], rem, qj), t.tinv[j], t.tinv_sh[j], qj);
          if constexpr (MODE == SCALE) {
            o[j * n] = v;
          } else {
            px[j * x_limb] = add_mod(px[j * x_limb], v, qj);
            if (o != nullptr) o[j * n] = shoup(v, t.r1[j], t.r1_sh[j], qj);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int apsu_scale_add(const void* m, long long m_inner, long long m_stride,
                              long long m_outer, void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, const void* y,
                              long long y_inner, long long y_stride, long long y_outer,
                              long long y_limb, void* out, int period, int skip, long long rows,
                              int n, int lq, int mode, const void* table, void* stream) {
  const bool ok = n > 0 && rows >= 0 && rows < (1LL << 31) && lq >= 1 && lq <= MAXQ &&
                  m_inner >= 1 && m_inner < (1LL << 31) && x_inner >= 1 &&
                  x_inner < (1LL << 31) && y_inner >= 1 && y_inner < (1LL << 31) &&
                  ((mode == SCALE && m != nullptr && out != nullptr) ||
                   (mode == SCALE_ADD && m != nullptr && x != nullptr &&
                    (out == nullptr || (period >= 1 && skip >= 0 && skip < period))) ||
                   (mode == ADD && x != nullptr && y != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  DeltaTable t;
  std::memcpy(&t, table, sizeof t);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pm = static_cast<const uint32_t*>(m);
  auto* px = static_cast<uint32_t*>(x);
  const auto* py = static_cast<const uint32_t*>(y);
  auto* o = static_cast<uint32_t*>(out);
  const dim3 grid = grid_for(rows, n);
  const Rows mw{static_cast<unsigned>(m_inner), m_stride, m_outer};
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  const Rows yw{static_cast<unsigned>(y_inner), y_stride, y_outer};
  auto run = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(pm, mw, px, xw, x_limb, py, yw, y_limb, o, period, skip,
                                    rows, n, lq, t);
  };
  const bool small = lq <= SMALL_Q;
  if (mode == SCALE) {
    small ? run(scale_add_kernel<SCALE, SMALL_Q>) : run(scale_add_kernel<SCALE, MAXQ>);
  } else if (mode == SCALE_ADD) {
    small ? run(scale_add_kernel<SCALE_ADD, SMALL_Q>) : run(scale_add_kernel<SCALE_ADD, MAXQ>);
  } else {
    small ? run(scale_add_kernel<ADD, SMALL_Q>) : run(scale_add_kernel<ADD, MAXQ>);
  }
  return static_cast<int>(cudaGetLastError());
}
