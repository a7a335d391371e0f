// Comparison variant of G4 (../rns_divround.cu): every launch on the build
// whose limb loops are unrolled to behz.cuh's MAXQ, without the second
// build at SMALL_Q that the package takes when the limb count fits.  Any
// call it does not take goes to the package's entry, renamed here.

#define apsu_rns_divround apsu_rns_divround_package
#include "../rns_divround.cu"
#undef apsu_rns_divround

extern "C" int apsu_rns_divround(const void* x, long long x_inner, long long x_stride,
                                 long long x_outer, const void* c, long long c_inner,
                                 long long c_stride, long long c_outer, long long c_comp,
                                 void* out, long long rows, int n, int top, int target, int mode,
                                 const void* table, void* stream) {
  const bool mine = n > 0 && rows > 0 && rows < (1LL << 31) && x_inner >= 1 &&
                    x_inner < (1LL << 31) && c_inner >= 1 && c_inner < (1LL << 31) &&
                    top >= 2 && top <= MAXQ && target >= 1 && target < top &&
                    ((mode == KEYSWITCH && target == top - 1 && c != nullptr) ||
                     mode == MODSWITCH);
  if (!mine)
    return apsu_rns_divround_package(x, x_inner, x_stride, x_outer, c, c_inner, c_stride,
                                     c_outer, c_comp, out, rows, n, top, target, mode, table,
                                     stream);
  DivTable t;
  std::memcpy(&t, table, sizeof t);
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  const Rows cw{static_cast<unsigned>(c_inner), c_stride, c_outer};
  auto run = [&](auto kernel) {
    kernel<<<grid_for(rows, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), xw, static_cast<const uint32_t*>(c), cw, c_comp,
        static_cast<uint32_t*>(out), rows, n, top, target, t);
  };
  if (mode == KEYSWITCH) {
    run(rns_divround_kernel<KEYSWITCH, MAXQ>);
  } else {
    run(rns_divround_kernel<MODSWITCH, MAXQ>);
  }
  return static_cast<int>(cudaGetLastError());
}
