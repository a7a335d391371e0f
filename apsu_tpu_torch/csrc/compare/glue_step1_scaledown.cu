// Comparison variant of G3, step 1 of its redesign alone: the first design's
// arithmetic (glue_pr12_scaledown.cu: a Shoup product and a modular add a
// term), with its loops unrolled to exactly the limb counts of each pair of
// ../behz.cuh's BEHZ_EXACT_PAIRS (the run-time guards stay, always true).
// Any other call goes to the first design's entry, renamed here.

#define apsu_behz_scaledown apsu_behz_scaledown_first
#include "glue_pr12_scaledown.cu"
#undef apsu_behz_scaledown

extern "C" int apsu_behz_scaledown(const void* xq, const void* xb, void* out, long long rows,
                                   int n, int lq, int lb, const void* table, void* stream) {
  if (!(n > 0 && rows > 0))
    return apsu_behz_scaledown_first(xq, xb, out, rows, n, lq, lb, table, stream);
  ScaleTable t;
  std::memcpy(&t, table, sizeof t);
  auto run = [&](auto kernel) {
    kernel<<<grid_for(rows, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(xq), static_cast<const uint32_t*>(xb),
        static_cast<uint32_t*>(out), rows, n, lq, lb, t);
    return static_cast<int>(cudaGetLastError());
  };
#define STEP1_CASE(Q, B) \
  if (lq == Q && lb == B) return run(behz_scaledown_kernel<Q, B>);
  BEHZ_EXACT_PAIRS(STEP1_CASE)
#undef STEP1_CASE
  return apsu_behz_scaledown_first(xq, xb, out, rows, n, lq, lb, table, stream);
}
