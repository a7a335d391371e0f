// Comparison variant of G1's first design (glue_pr12_lift.cu): every lift
// and digits launch on the build whose q loops are unrolled to behz.cuh's
// MAXQ, without the second build at SMALL_Q that the first design took when
// the limb counts fit.  Any other launch goes to its entry, renamed here.

#define apsu_behz_lift apsu_behz_lift_package
#include "glue_pr12_lift.cu"
#undef apsu_behz_lift

extern "C" int apsu_behz_lift(const void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, void* out_q, void* out_b,
                              long long rows, int n, int lq, int lb, int mode,
                              const void* table, void* stream) {
  const bool mine = n > 0 && rows > 0 && rows < (1LL << 31) && x_inner >= 1 &&
                    x_inner < (1LL << 31) && out_b != nullptr && lq >= 1 && lq <= MAXQ &&
                    lb >= 1 && lb <= (mode == DIGITS ? MAXQ : MAXB) &&
                    (mode == LIFT || mode == DIGITS);
  if (!mine)
    return apsu_behz_lift_package(x, x_inner, x_stride, x_outer, x_limb, out_q, out_b, rows, n,
                                  lq, lb, mode, table, stream);
  LiftTable t;
  std::memcpy(&t, table, sizeof t);
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  auto run = [&](auto kernel) {
    kernel<<<grid_for(rows, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), xw, x_limb, static_cast<uint32_t*>(out_q),
        static_cast<uint32_t*>(out_b), rows, n, lq, lb, t);
  };
  if (mode == LIFT) {
    run(behz_lift_kernel<LIFT, MAXQ, MAXB>);
  } else {
    run(behz_lift_kernel<DIGITS, MAXQ, MAXQ>);
  }
  return static_cast<int>(cudaGetLastError());
}
