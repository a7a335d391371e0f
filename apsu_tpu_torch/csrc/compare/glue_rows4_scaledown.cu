// Comparison variant of G3: the package's kernel (../behz_scaledown.cu, its
// entry renamed here) at 4 rows a block instead of ROWS_PER_BLOCK, each
// thread issuing the next row's loads before the current row's arithmetic
// (step 3 of the redesign in registers, as the lift takes it).

#define apsu_behz_scaledown apsu_behz_scaledown_package
#include "../behz_scaledown.cu"
#undef apsu_behz_scaledown

extern "C" int apsu_behz_scaledown(const void* xq, const void* xb, void* out, long long rows,
                                   int n, int lq, int lb, const void* table, void* stream) {
  return scaledown_launch<4>(xq, xb, out, rows, n, lq, lb, table, stream);
}
