// p1_fused_closed2 under two compile-time switches, for Hopper (sm_90a):
// the tie rule of the tile argmax and the left rows of a block.
//
// Replaces the Pallas A/B probe variant of the JAX package
// (benchmarks/ab_p1_epilogue.py:160-200: bodies _p1_body_minidx :92-157,
// the argmax as the smallest column among the maxima, and _p1_body; its
// block_m sweep :207-214).  It is mode kClosed of the scan in
// p1_scan_sm90.cuh (design and bound there), instantiated four times:
//   minidx = 0  the shipped rule: a thread's columns in increasing order
//               with a strict >, then the quad's merge where the smaller
//               column wins ties (kFirst)
//   minidx = 1  the probe's rule: the maximum, then the smallest column
//               among the scores equal to it, each merged across the quad
//               (kMinIdx)
//   block_rows = 128  the shipped block: two consumer warpgroups
//   block_rows = 64   one consumer warpgroup: A's rows take half the shared
//                     memory and the B ring deepens, but every block still
//                     streams all of B, so B's L2 reads double for the same
//                     operations (2*m*n*d at 989 TF/s bounds all four)
// The two rules define the same column and the block holds whole rows, so
// every instantiation's (ship, counts, tmax, bound) is bitwise
// p1_fused_closed2's; only the time differs.  block_rows = 128, minidx = 0
// is p1_fused_closed2 itself.

#include "p1_scan_sm90.cuh"

extern "C" int p1_closed2_variant(const void* a, const void* b, float thr,
                                  int64_t m, int64_t n, int64_t d,
                                  int64_t tile, int64_t cand_c,
                                  int64_t block_rows, int64_t minidx,
                                  void* ship, void* counts, void* tmax,
                                  void* bound, void* vbuf, void* stream) {
  p1h::Args p{};
  p.A = static_cast<const __nv_bfloat16*>(a);
  p.B = static_cast<const __nv_bfloat16*>(b);
  p.thr = thr;
  p.m = static_cast<int>(m);
  p.n = static_cast<int>(n);
  p.d = static_cast<int>(d);
  p.tile = static_cast<int>(tile);
  p.cand_c = static_cast<int>(cand_c);
  p.v = static_cast<float*>(vbuf);
  p.c = static_cast<int*>(ship);
  p.counts = static_cast<int*>(counts);
  p.tmax = static_cast<int*>(tmax);
  p.bound = static_cast<float*>(bound);
  using p1h::kClosed;
  using p1h::kFirst;
  using p1h::kMinIdx;
  if (block_rows == 128)
    return minidx ? p1h::launch<kClosed, 128, kMinIdx>(p, stream)
                  : p1h::launch<kClosed, 128, kFirst>(p, stream);
  if (block_rows == 64)
    return minidx ? p1h::launch<kClosed, 64, kMinIdx>(p, stream)
                  : p1h::launch<kClosed, 64, kFirst>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
