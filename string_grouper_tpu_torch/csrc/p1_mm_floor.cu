// The matmul floor under the fused phase-1 epilogue, for Hopper (sm_90a):
// per left row, the count of right columns with s = A . B^T >= thr (bf16
// products, f32 accumulation) over all n columns, and nothing else.
//
// Replaces the Pallas A/B probe mm_floor of the JAX package
// (benchmarks/ab_p1_epilogue.py:65-88, body _mm_body :56-62), which timed
// the product and the threshold count as the floor under
// p1_fused_closed2's epilogue.  Here it is mode kCount of the scan in
// p1_scan_sm90.cuh: the same TMA ring, the same wgmma and block shape and
// the same k order as p1_fused_closed2 (kClosed), so the difference of the
// two times is the epilogue's, and the counts are bitwise kClosed's.
// Bound on the H100: the tensor cores, 2*m*n*d operations at 989 TF/s;
// the epilogue is one max per row and 32 columns of a thread, and a count
// where the max reaches thr.  No top-C buffers, one int32 per row written.

#include "p1_scan_sm90.cuh"

extern "C" int p1_mm_floor(const void* a, const void* b, float thr, int64_t m,
                           int64_t n, int64_t d, void* counts, void* stream) {
  p1h::Args p{};
  p.A = static_cast<const __nv_bfloat16*>(a);
  p.B = static_cast<const __nv_bfloat16*>(b);
  p.thr = thr;
  p.m = static_cast<int>(m);
  p.n = static_cast<int>(n);
  p.d = static_cast<int>(d);
  p.tile = static_cast<int>(n);  // kCount keeps no tile state
  p.counts = static_cast<int*>(counts);
  return p1h::launch<p1h::kCount>(p, stream);
}
