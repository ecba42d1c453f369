// Triangular self-join phase 1 for Hopper (sm_90a), one left segment.
//
// Replaces the Pallas kernel p1_tri_fused of the JAX package
// (string_grouper_tpu/ops/pallas_kernels.py:631-726, body _p1_tri_body
// :414-623, packed future state :393-411).  The segment's rows (global rows
// from j0 * tile, cpg tiles) meet every right tile j >= j0 once; each
// product feeds both sides:
// * row side: the segment rows' running top-C over tiles j >= j0, in j
//   order, with meta [cnt, tmax, bound, nfin] (rv, rc, rmeta);
// * column side, tiles j >= j0 + cpg only: per column, the closed-form
//   top-2 over each block_m-row sub-block k of left tile I, merged over k
//   by the sorted-pair rule (:549-573), then rank-inserted into the
//   column's packed future state in I order, with its meta update
//   (:593-604).  Later segments run later launches, so across launches the
//   folds follow segment order.
//
// What bounds it on the H100: the tensor cores, as for p1_fused_closed2 --
// (seg_rows x (n_pad - j0*tile) x d) products, about half the square
// scan's over all segments -- plus the column statistics, written once and
// read once (20 bytes per 128 rows of a future column, 4 where no score
// qualifies).
//
// Design: two launches on the caller's stream.
// (a) scan_kernel<kTri> (p1_scan_sm90.cuh): the TMA/wgmma scan of
//     p1_fused_closed2 with its row-side epilogue from registers, walking
//     B from column j0 * tile (A resident up to d = 512, streamed through
//     the ring past it); for the future columns the same registers also
//     give (count, row sum, max, first argmax row, second max) per (128-row
//     chunk, column), through shared-memory atomics into global
//     statistics.  Each (I, j) product is computed once.
// (b) tri_fold_kernel: one thread per future column walks I, then k, then
//     the block_m / 128 chunks of sub-block k in order, merges the chunk
//     statistics exactly into the sub-block's closed form, folds the
//     sub-blocks by the sorted-pair rule and rank-inserts each tile I's
//     top-2 into the column's row of fpack.  Columns with no qualified
//     score in tile I skip the insert: it would only rewrite column ids of
//     -inf slots, which are unspecified.

#include "p1_scan_sm90.cuh"

namespace {

using p1h::NEG;

constexpr int FUT_C = 60;      // candidate slots of the packed future state
constexpr int META_OFF = 120;  // first meta slot

__global__ void tri_fold_kernel(const int* __restrict__ st_cnt,
                                const int* __restrict__ st_s1,
                                const int* __restrict__ st_row,
                                const float* __restrict__ st_v,
                                const float* __restrict__ st_v2,
                                int64_t n_fut, int cpg, int tile, int bm,
                                int64_t row_base, int64_t fut0,
                                float* __restrict__ fpack) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n_fut) return;
  const int tpb = tile / bm;
  const int cpb = bm / p1h::BM;
  float* fv = fpack + (fut0 + col) * 128;
  int* fc = reinterpret_cast<int*>(fv + FUT_C);
  float* fm = fv + META_OFF;
  for (int I = 0; I < cpg; ++I) {
    float a0 = NEG, a1 = NEG;
    int ca0 = 0, ca1 = 0, cnt_tile = 0;
    float sub_bound = NEG;
    for (int k = 0; k < tpb; ++k) {
      // sub-block k of tile I: the closed form from its chunks' statistics
      int cnt = 0, s1 = 0, rm = 0x7fffffff;
      float vm = NEG, vm2 = NEG;
      const int64_t ch0 = (static_cast<int64_t>(I) * tile + static_cast<int64_t>(k) * bm) / p1h::BM;
      for (int q = 0; q < cpb; ++q) {
        const int64_t idx = (ch0 + q) * n_fut + col;
        const int c = st_cnt[idx];
        if (c > 0) {
          cnt += c;
          s1 += st_s1[idx] + p1h::BM * q * c;
          p1h::merge_top2(vm, rm, vm2, st_v[idx], st_row[idx] + p1h::BM * q, st_v2[idx]);
        }
      }
      const bool ch1 = cnt >= 1, ch2 = cnt == 2;
      const int roff = static_cast<int>(row_base + static_cast<int64_t>(I) * tile +
                                        static_cast<int64_t>(k) * bm);
      const float b0 = ch1 ? vm : NEG;
      const float b1 = ch2 ? vm2 : NEG;
      const int d0 = (ch1 ? rm : 0) + roff;
      const int d1 = (ch2 ? s1 - rm : 0) + roff;
      // sorted-pair merge of (a0 >= a1) with (b0 >= b1); ties keep a
      const bool awins = a0 >= b0;
      const float l0v = awins ? b0 : a0;
      const int l0c = awins ? d0 : ca0;
      const float wsv = awins ? a1 : b1;
      const int wsc = awins ? ca1 : d1;
      if (!awins) {
        a0 = b0;
        ca0 = d0;
      }
      const bool lwins = l0v >= wsv;
      a1 = lwins ? l0v : wsv;
      ca1 = lwins ? l0c : wsc;
      cnt_tile += cnt;
      if (cnt > 2) sub_bound = fmaxf(sub_bound, vm2);
    }
    if (cnt_tile == 0) continue;  // nothing to fold: meta and values stay
    // rank insert (a0, ca0), (a1, ca1) into the column's sorted-desc slots
    int i0 = 0, i1 = 1;
    for (int k = 0; k < FUT_C; ++k) {
      const float x = fv[k];
      i0 += x > a0;
      i1 += x > a1;
    }
    for (int k = FUT_C - 1; k >= 0; --k) {  // sources lie at or below k
      if (k == i1) {
        fv[k] = a1;
        fc[k] = ca1;
      } else if (k == i0) {
        fv[k] = a0;
        fc[k] = ca0;
      } else {
        const int src = k - (k > i0) - (k > i1);
        fv[k] = fv[src];
        fc[k] = fc[src];
      }
    }
    const float cf = static_cast<float>(cnt_tile);
    const float tile_bound = fmaxf(cnt_tile > 2 ? a1 : NEG, sub_bound);
    fm[0] = fm[0] + cf;
    fm[1] = fmaxf(fm[1], cf);
    fm[2] = fmaxf(fm[2], tile_bound);
    fm[3] = fm[3] + 1.f + (cnt_tile >= 2 ? 1.f : 0.f);
  }
}

}  // namespace

extern "C" int p1_tri_fused(const void* a, const void* b, float thr,
                            int64_t j0, int64_t seg_rows, int64_t n_pad,
                            int64_t d, int64_t tile, int64_t cand_c,
                            int64_t block_m, void* rv, void* rc, void* rmeta,
                            void* fpack, void* stats_i, void* stats_f,
                            void* stream) {
  const int64_t cpg = seg_rows / tile;
  const int64_t col0 = j0 * tile;  // first walked column = first segment row
  const int64_t n_fut = n_pad - col0 - cpg * tile;
  const int64_t size = (seg_rows / p1h::BM) * n_fut;
  int* si = static_cast<int*>(stats_i);
  float* sf = static_cast<float*>(stats_f);
  p1h::Args p{};
  p.A = static_cast<const __nv_bfloat16*>(a);
  p.B = static_cast<const __nv_bfloat16*>(b) + col0 * d;
  p.thr = thr;
  p.m = static_cast<int>(seg_rows);
  p.n = static_cast<int>(n_pad - col0);
  p.d = static_cast<int>(d);
  p.tile = static_cast<int>(tile);
  p.cand_c = static_cast<int>(cand_c);
  p.col_off = static_cast<int>(col0);
  p.v = static_cast<float*>(rv);
  p.c = static_cast<int*>(rc);
  p.rmeta = static_cast<float*>(rmeta);
  p.fut_start = static_cast<int>(cpg * tile);
  p.n_fut = n_fut;
  p.st_cnt = si;
  p.st_s1 = si + size;
  p.st_row = si + 2 * size;
  p.st_v = sf;
  p.st_v2 = sf + size;
  int e = p1h::launch_scan<p1h::kTri>(p, stream);
  if (e != 0 || n_fut == 0) return e;
  constexpr int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n_fut + threads - 1) / threads);
  tri_fold_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      si, si + size, si + 2 * size, sf, sf + size, n_fut,
      static_cast<int>(cpg), static_cast<int>(tile), static_cast<int>(block_m),
      col0, col0 + cpg * tile, static_cast<float*>(fpack));
  return static_cast<int>(cudaGetLastError());
}

// p1h_plan: the plan of this library's launch at width d (p1h::plan_info).
P1H_EXPORT_PLAN(p1h::kTri)
