// Escalation's phase-1 re-match for Hopper (sm_90a): one pass over the
// whole right corpus that keeps each tile's top kt (4, 8, 16 or 32) per
// left row.
//
// Replaces the XLA tile body _ub_topk_scan of the JAX package at
// 4 <= kt <= 32 (string_grouper_tpu/ops/matcher.py:703; the iterated
// max / argmax extraction), which the port ran as torch ops: an f32
// product per 4096-column tile written to device memory, then kt rounds of
// max, argmax and scatter over it.  Here it is mode kTopK of the scan in
// p1_scan_sm90.cuh (design there): the product of p1_fused_closed2 (TMA
// ring, wgmma, A resident up to d = 512, the same k order, so a row's
// scores are phase 1's bits) with a top-kt epilogue from registers.  No
// score reaches device memory.
// Bound on the H100: the tensor cores, 2*m*n*d operations at 989 TF/s.
// The epilogue appends a row's few qualified scores to shared memory and
// merges them into the running top-C at the tile's end, so it costs little
// beside the product when rows qualify sparsely, as escalated rows do
// (escalation buckets them by phase 1's largest per-tile count).
//
// Two kernels, one launch of the wrapper: the scan over a grid of (row
// blocks, splits) -- each split a contiguous range of whole tiles, so that
// a job of few rows still fills the card -- writes every split's running
// top-C and counters; topk_merge_kernel joins the splits of each row in
// split order (a stable merge: bitwise one pass over all tiles) and writes the
// outputs of p1_fused_closed2: ship (m, cand_c) with -1 sentinels and each
// row's valid entries a descending prefix, counts, tmax and bound =
// max(tile drop bound, the C-th value when more than C finite candidates
// were extracted).  The merge reads each split's finite prefix, one warp a
// row, an entry's place by a binary search in every other split: a few
// loads per candidate, small beside the scan.

#include "p1_scan_sm90.cuh"

namespace {

constexpr int MERGE_WARPS = 8;  // rows of a merge block

// Entries of the desc-sorted list v[0, len) that are >= x (or > x).
__device__ __forceinline__ int count_above(const float* v, int len, float x, bool ge) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ge ? v[mid] >= x : v[mid] > x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// p.v / p.c: the splits' (splits, m, C) lists; p.meta (splits, m, 3) and
// p.tb (splits, m): their counters.  Out: p.ship, p.counts, p.tmax, p.bound.
__global__ void __launch_bounds__(32 * MERGE_WARPS)
    topk_merge_kernel(const p1h::Args p, int splits) {
  __shared__ int lens[MERGE_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * MERGE_WARPS + w;
  if (row >= p.m) return;
  const int C = p.cand_c;
  const int64_t mc = static_cast<int64_t>(p.m) * C;
  int cnt = 0, tmx = 0, nf = 0;
  float bnd = p1h::NEG;
  if (lane < splits) {
    const int64_t g = static_cast<int64_t>(lane) * p.m + row;
    cnt = p.meta[3 * g];
    tmx = p.meta[3 * g + 1];
    nf = p.meta[3 * g + 2];
    bnd = p.tb[g];
  }
  int len = min(nf, C);
  lens[w][lane] = len;
  __syncwarp();
  int total = len;
  for (int o = 16; o; o >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    tmx = max(tmx, __shfl_xor_sync(0xffffffffu, tmx, o));
    nf += __shfl_xor_sync(0xffffffffu, nf, o);
    total += __shfl_xor_sync(0xffffffffu, total, o);
    bnd = fmaxf(bnd, __shfl_xor_sync(0xffffffffu, bnd, o));
  }
  int* ship = p.ship + static_cast<int64_t>(row) * C;
  // entry i of split s lands after the entries ahead of it: its own
  // split's first i, the >= ones of earlier splits, the > ones of later
  float trunc = p1h::NEG;
  for (int s = 0; s < splits; ++s) {
    const int64_t g = s * mc + static_cast<int64_t>(row) * C;
    for (int i = lane; i < lens[w][s]; i += 32) {
      const float x = p.v[g + i];
      int pos = i;
      for (int t = 0; t < splits && pos < C; ++t)
        if (t != s) pos += count_above(p.v + t * mc + static_cast<int64_t>(row) * C,
                                       lens[w][t], x, t < s);
      if (pos < C) {
        ship[pos] = p.c[g + i];
        if (pos == C - 1) trunc = x;
      }
    }
  }
  for (int k = total + lane; k < C; k += 32) ship[k] = -1;
  for (int o = 16; o; o >>= 1) trunc = fmaxf(trunc, __shfl_xor_sync(0xffffffffu, trunc, o));
  if (lane == 0) {
    p.counts[row] = cnt;
    p.tmax[row] = tmx;
    p.bound[row] = fmaxf(bnd, nf > C ? trunc : p1h::NEG);
  }
}

// The scan over (row blocks, splits) at kt = topk_kt(MODE).
template <int MODE>
int launch_split(p1h::Args p, int splits, void* stream) {
  p1h::Plan q;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int c = p1h::configure<MODE, p1h::BM, p1h::kFirst, false>(p, stream, q, cfg, attr);
  if (c != 0) return c;
  p.stages = q.stages;
  cfg.gridDim.y = static_cast<unsigned>(splits);
  CUtensorMap tm_a, tm_b;
  int e = p1h::make_map(&tm_a, p.A, p.m, p.d, p1h::BM);
  if (e == 0) e = p1h::make_map(&tm_b, p.B, p.n, p.d);
  if (e != 0) return e;
  auto kernel = p1h::scan_kernel<MODE, p1h::BM, p1h::kFirst, false>;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_b, p);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

extern "C" int p1_fused_topk(const void* a, const void* b, float thr, int64_t m,
                             int64_t n, int64_t d, int64_t tile, int64_t cand_c,
                             int64_t k_tile, int64_t splits, void* ship, void* counts,
                             void* tmax, void* bound, void* v_split, void* c_split,
                             void* meta_split, void* tb_split, void* stream) {
  p1h::Args p{};
  p.A = static_cast<const __nv_bfloat16*>(a);
  p.B = static_cast<const __nv_bfloat16*>(b);
  p.thr = thr;
  p.m = static_cast<int>(m);
  p.n = static_cast<int>(n);
  p.d = static_cast<int>(d);
  p.tile = static_cast<int>(tile);
  p.cand_c = static_cast<int>(cand_c);
  p.v = static_cast<float*>(v_split);
  p.c = static_cast<int*>(c_split);
  p.meta = static_cast<int*>(meta_split);
  p.tb = static_cast<float*>(tb_split);
  p.ship = static_cast<int*>(ship);
  p.counts = static_cast<int*>(counts);
  p.tmax = static_cast<int*>(tmax);
  p.bound = static_cast<float*>(bound);
  const int sp = static_cast<int>(splits);
  if (sp < 1 || sp > 32 || sp > n / tile) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (k_tile) {
    case 4:
      err = launch_split<p1h::topk_mode(4)>(p, sp, stream);
      break;
    case 8:
      err = launch_split<p1h::topk_mode(8)>(p, sp, stream);
      break;
    case 16:
      err = launch_split<p1h::topk_mode(16)>(p, sp, stream);
      break;
    case 32:
      err = launch_split<p1h::topk_mode(32)>(p, sp, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const unsigned blocks = static_cast<unsigned>((m + MERGE_WARPS - 1) / MERGE_WARPS);
  topk_merge_kernel<<<blocks, 32 * MERGE_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, sp);
  return static_cast<int>(cudaGetLastError());
}
