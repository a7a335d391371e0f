// Comparison variant of G1's lift, step 1 of its redesign alone: the first
// design's arithmetic (glue_pr12_lift.cu: a Shoup product and a modular add
// a term), with its loops unrolled to exactly the limb counts of each pair
// of ../behz.cuh's BEHZ_EXACT_PAIRS (the run-time guards stay, always
// true).  Any other launch goes to the first design's entry, renamed here.

#define apsu_behz_lift apsu_behz_lift_first
#include "glue_pr12_lift.cu"
#undef apsu_behz_lift

extern "C" int apsu_behz_lift(const void* x, long long x_inner, long long x_stride,
                              long long x_outer, long long x_limb, void* out_q, void* out_b,
                              long long rows, int n, int lq, int lb, int mode,
                              const void* table, void* stream) {
  const bool mine = mode == LIFT && n > 0 && rows > 0 && rows < (1LL << 31) && x_inner >= 1 &&
                    x_inner < (1LL << 31) && out_b != nullptr;
  if (!mine)
    return apsu_behz_lift_first(x, x_inner, x_stride, x_outer, x_limb, out_q, out_b, rows, n,
                                lq, lb, mode, table, stream);
  LiftTable t;
  std::memcpy(&t, table, sizeof t);
  const Rows xw{static_cast<unsigned>(x_inner), x_stride, x_outer};
  auto run = [&](auto kernel) {
    kernel<<<grid_for(rows, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(x), xw, x_limb, static_cast<uint32_t*>(out_q),
        static_cast<uint32_t*>(out_b), rows, n, lq, lb, t);
    return static_cast<int>(cudaGetLastError());
  };
#define STEP1_CASE(Q, B) \
  if (lq == Q && lb == B) return run(behz_lift_kernel<LIFT, Q, B>);
  BEHZ_EXACT_PAIRS(STEP1_CASE)
#undef STEP1_CASE
  return apsu_behz_lift_first(x, x_inner, x_stride, x_outer, x_limb, out_q, out_b, rows, n, lq,
                              lb, mode, table, stream);
}
