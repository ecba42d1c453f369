// Fused phase-1 candidate filter for Hopper (sm_90a): one pass over the
// whole right corpus.
//
// Replaces the Pallas kernel p1_fused_closed2 of the JAX package
// (string_grouper_tpu/ops/pallas_kernels.py:117-179, body _p1_body :47-114,
// rank insert _rank_insert2 :362-380).  The scan, what bounds it and its
// design (TMA, wgmma, epilogue from registers) are in p1_scan_sm90.cuh
// (mode kClosed; A resident up to d = 512, streamed through the ring
// past it).  At the end: bound = max(tile drop bound, v[C-1] when
// more than C finite candidates were extracted); ship = column where
// v > -inf else -1 (the valid entries form a prefix), written over the
// running column buffer.

#include "p1_scan_sm90.cuh"

extern "C" int p1_fused_closed2(const void* a, const void* b, float thr,
                                int64_t m, int64_t n, int64_t d, int64_t tile,
                                int64_t cand_c, void* ship, void* counts,
                                void* tmax, void* bound, void* vbuf,
                                void* stream) {
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
  return p1h::launch_scan<p1h::kClosed>(p, stream);
}

// p1h_plan: the plan of this library's launch at width d (p1h::plan_info).
P1H_EXPORT_PLAN(p1h::kClosed)
