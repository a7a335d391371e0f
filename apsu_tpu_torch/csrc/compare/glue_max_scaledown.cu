// Comparison variant of G3's first design (glue_pr12_scaledown.cu): every
// launch on the build whose q loops are unrolled to behz.cuh's MAXQ, without
// the second build at SMALL_Q that the first design took when the limb
// counts fit.  Any call it does not take goes to its entry, renamed here.

#define apsu_behz_scaledown apsu_behz_scaledown_package
#include "glue_pr12_scaledown.cu"
#undef apsu_behz_scaledown

extern "C" int apsu_behz_scaledown(const void* xq, const void* xb, void* out, long long rows,
                                   int n, int lq, int lb, const void* table, void* stream) {
  if (!(n > 0 && rows > 0 && lq >= 1 && lq <= MAXQ && lb >= 2 && lb <= MAXB))
    return apsu_behz_scaledown_package(xq, xb, out, rows, n, lq, lb, table, stream);
  ScaleTable t;
  std::memcpy(&t, table, sizeof t);
  behz_scaledown_kernel<MAXQ, MAXB><<<grid_for(rows, n), THREADS, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xq), static_cast<const uint32_t*>(xb),
      static_cast<uint32_t*>(out), rows, n, lq, lb, t);
  return static_cast<int>(cudaGetLastError());
}
