// Comparison variant of G1, steps 1 and 2 of the lift's redesign alone
// (exact limb counts, lazy 64-bit sums): the package's kernel
// (../behz_lift.cu, its entry renamed here) with the lift launched one row
// a block, so no row's loads are in flight during another row's arithmetic.

#define apsu_behz_lift apsu_behz_lift_package
#include "../behz_lift.cu"
#undef apsu_behz_lift

extern "C" int apsu_behz_lift(const void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, void* out_q, void* out_b,
                              long long rows, int n, int lq, int lb, int mode,
                              const void* table, void* stream) {
  return lift_launch<1>(x, x_inner, x_stride, x_outer, x_limb, out_q, out_b, rows, n, lq, lb,
                        mode, table, stream);
}
