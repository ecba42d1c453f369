// Chained phase-1 pass for Hopper (sm_90a): the fused scan over one right
// column chunk, resuming from the previous chunk's state.
//
// Replaces the Pallas kernel p1_fused_chain of the JAX package
// (string_grouper_tpu/ops/pallas_kernels.py:275-358, body _p1_chain_body
// :183-257).  The scan, what bounds it and its design (TMA, wgmma,
// epilogue from registers) are in p1_scan_sm90.cuh (mode kChain; A
// resident up to d = 512, streamed past it).  It
// differs from p1_fused_closed2 in three ways:
// * the running top-C (v, c) is the caller's state, updated in place, and
//   the per-row counters start from the state's meta [counts, tmax, nfin]
//   (int32: exact at any size, where the JAX kernel packs them into f32)
//   and drop bound tb, which are written back at the end;
// * col_off, the chunk's first global column, is added to every column id;
// * ship (v > -inf ? c : -1) is a separate output, and bound covers the
//   columns seen so far.
// With chunk bounds aligned to the logical tile, every row sees the same
// rank-insert sequence as in one p1_fused_closed2 pass over the
// concatenated chunks, so the last pass's outputs are bitwise that pass's.

#include "p1_scan_sm90.cuh"

extern "C" int p1_fused_chain(const void* a, const void* b, float thr,
                              int64_t col_off, int64_t m, int64_t n,
                              int64_t d, int64_t tile, int64_t cand_c,
                              void* v, void* c, void* meta, void* tb,
                              void* ship, void* counts, void* tmax,
                              void* bound, void* stream) {
  p1h::Args p{};
  p.A = static_cast<const __nv_bfloat16*>(a);
  p.B = static_cast<const __nv_bfloat16*>(b);
  p.thr = thr;
  p.m = static_cast<int>(m);
  p.n = static_cast<int>(n);
  p.d = static_cast<int>(d);
  p.tile = static_cast<int>(tile);
  p.cand_c = static_cast<int>(cand_c);
  p.col_off = static_cast<int>(col_off);
  p.v = static_cast<float*>(v);
  p.c = static_cast<int*>(c);
  p.meta = static_cast<int*>(meta);
  p.tb = static_cast<float*>(tb);
  p.ship = static_cast<int*>(ship);
  p.counts = static_cast<int*>(counts);
  p.tmax = static_cast<int*>(tmax);
  p.bound = static_cast<float*>(bound);
  return p1h::launch_scan<p1h::kChain>(p, stream);
}

// p1h_plan: the plan of this library's launch at width d (p1h::plan_info).
P1H_EXPORT_PLAN(p1h::kChain)
