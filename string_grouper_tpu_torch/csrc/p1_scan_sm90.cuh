// The fused phase-1 scan for Hopper (sm_90a), built on TMA, mbarriers and
// wgmma, shared by five kernels:
//   p1_fused_closed2.cu  one pass over the whole right corpus   (kClosed)
//   p1_fused_chain.cu    one pass over a right column chunk,
//                        resuming from the previous chunk's state (kChain)
//   p1_tri_fused.cu      one segment of the triangular self-join: the row
//                        side from the segment's first column on, plus
//                        per-column statistics of the future columns (kTri)
//   p1_mm_floor.cu       the product and the per-row qualified count only,
//                        the floor under kClosed's epilogue       (kCount)
//   p1_closed2_variant.cu  kClosed under two compile-time switches: the
//                        tie rule of the argmax (TIE) and the left rows
//                        of a block (ROWS, 128 or 64)
// It replaces the Pallas kernels p1_fused_closed2, p1_fused_chain and the
// scan of p1_tri_fused of the JAX package
// (string_grouper_tpu/ops/pallas_kernels.py:117-179, :275-358 and
// :631-726; bodies _p1_body :47-114, _p1_chain_body :183-257 and
// _p1_tri_body :414-623), and the A/B probes mm_floor and variant of
// benchmarks/ab_p1_epilogue.py (:65-88, body _mm_body :56-62; :160-200,
// bodies _p1_body_minidx :92-157 and _p1_body).
//
// For one block of 128 left rows of A (m, d) bf16 against the walked right
// columns B (n, d) bf16 it computes, per row and per logical tile of `tile`
// columns: s = A . B^T (bf16 products, f32 accumulation); qualified =
// s >= thr; the qualified count, the sum of the qualified tile-local column
// indices, the maximum and its first column (argmax), and the maximum with
// that column masked; the running per-row counts, tmax (largest per-tile
// count), nfin (candidates extracted), the drop bound tb of tiles with more
// than 2 qualified columns, and the rank insert (_rank_insert2 :362-380) of
// the tile's <= 2 closed-form candidates into a sorted-desc running top-C.
//
// What bounds it on the H100: the tensor cores, 2*m*n*d operations at
// 989 TF/s dense bf16.  Second, B's traffic from L2 to the SMs: every block
// of 128 rows streams all of B, 2*128 operations per bf16 element of B
// (128 per byte), so the full tensor-core rate needs ~7.7 TB/s of L2 reads
// across the card.
//
// Design:
// * A block owns 128 left rows and walks every right column in order, 128
//   columns (a sub-block) at a time; the Pallas grid's sequential tile axis
//   is this loop, so every row sees its rank inserts in column order and
//   chained passes over tile-aligned chunks are bitwise one pass.
// * 3 warpgroups.  Warpgroup 2 is the producer: one thread issues TMA
//   loads.  A's 128 x d rows arrive once, as d/64 boxes of 128 rows x 64 k
//   in the 128-byte swizzled K-major layout that wgmma reads (TMA fills rows
//   past m with zeros); B streams through a ring of 5-8 stages (128 columns
//   x 64 k, 16 KB each; as many as fit, at most 8) with full/empty
//   mbarriers, and the producer keeps them in flight across sub-block and
//   tile boundaries.  setmaxnreg gives the producer 40 registers and the
//   consumers 232.
// * Warpgroups 0 and 1 are the consumers, 64 rows each: wgmma m64n128k16
//   from shared memory, f32 accumulators in registers, one commit group per
//   stage, a stage released as soon as the wgmma that read it completes.
//   Each consumer keeps two accumulators: it issues sub-block s+1's first
//   stage, waits for sub-block s, runs s's epilogue while s+1's product is
//   in flight, then issues the rest of s+1.
// * Epilogue from registers, no score round trip: a thread holds 2 rows x
//   32 columns of the sub-block (the accumulator layout: a row's 128
//   columns lie in the 4 lanes of a quad).  Per sub-block it updates a
//   running tile state for its two rows over its own columns in increasing
//   order (count, index sum, max, first argmax with strict >, second max);
//   a row whose 32 scores are all below thr costs one max and one compare.
//   At a tile's end, 2 xor-shuffle rounds merge the state across the quad
//   with "smaller column wins ties" (jnp.argmax's first occurrence); every
//   lane of the quad then holds the row's tile result and running counters
//   (counts, tmax, nfin, tb live in registers for the whole walk).  The
//   warp then rank-inserts, row after row, the rows with a qualified
//   column into their running top-C in global memory (v + c, L2-resident),
//   warp-wide.  Tiles with no qualified column skip the insert, so the
//   column id of a -inf slot is unspecified.
// * kTri's column side, from the same registers: for walked columns from
//   `fut_start` on, every qualified score also folds into its column's
//   statistics over the block's 128 rows, kept in shared memory: count and
//   row sum by integer atomic adds, the maximum and its first row by one
//   64-bit atomic max of (order-preserving bits of the score, ~row), and
//   the second maximum by an atomic max of whichever key loses (on arrival,
//   or when a larger key displaces it).  Every step is commutative, so the
//   statistics are the same bits in any order of arrival.  Those sub-blocks
//   run their own instantiation of the epilogue (sub_block<true>); the
//   others run kClosed's.  A score below thr costs nothing there: the row
//   side's per-row max already skips it.  The last of the 8 consumer warps
//   to finish such a sub-block (a shared counter) writes the 128 columns'
//   statistics to global memory (count densely, the rest where count > 0)
//   and clears them; no warp waits for another.  col_bufs buffers, enough
//   that no warp can reach a buffer's next sub-block before its flush.
//   What this costs: a qualified score's atomics are shared-memory round
//   trips on the block's critical path (the 64-bit max is a CAS loop), and
//   every consumer warp waits for its warpgroup's slowest at the next
//   wgmma; the flush reads shared memory every future sub-block.  The
//   statistics and counters take 2.5-12.5 KB of shared memory, one ring
//   stage at d = 512.
// * TMA descriptors are built on the host per launch (the pointers change
//   with every segment and chunk) and passed as __grid_constant__
//   parameters.  cuTensorMapEncodeTiled is a driver-API function; it is
//   reached through the runtime's driver entry point
//   (cudaGetDriverEntryPointByVersion, or cudaGetDriverEntryPoint before
//   CUDA 12.5), so the libraries link no libcuda.  A failed encode returns
//   kEncodeError + its CUresult.
//
// * The switches of p1_closed2_variant (kClosed only; the defaults are the
//   shipped kernel).  TIE = kMinIdx is the probe's argmax: the maximum
//   first, then the smallest column among the scores equal to it, then the
//   maximum with that column masked -- per sub-block over the thread's
//   columns, and again at each merge (into the open tile, across the quad).
//   kFirst and kMinIdx define the same column, so the outputs are the same
//   bits.  ROWS = 64: one consumer warpgroup (256 threads; no setmaxnreg,
//   the 64K registers already give a thread 255), A's 64 rows take half the
//   shared memory, so the ring deepens (8 stages at d = 512 against 6); each
//   block still streams all of B, so B's L2 reads double for the same
//   operations.
// * kCount: the epilogue of a sub-block is the per-row maximum, and where
//   it reaches thr a count of the thread's qualified scores into a
//   per-thread counter; no tile state, no rank insert, no top-C buffers.
//   The counters are summed across the quad once, after the walk.  The
//   product's k order is kClosed's, so the counts are its bits.
//
// Left for later: wave quantization (one block of 128 rows per SM: 576
// blocks on 132 SMs at the 663k segment, 4.36 waves); thread-block
// clusters with TMA multicast of B to two SMs, which halves B's L2 traffic
// -- the next lever if the scan is bound by L2 reads rather than the
// tensor cores.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace p1h {

constexpr int BM = 128;         // left rows per block
constexpr int BN = 128;         // right columns per sub-block
constexpr int BK = 64;          // k per TMA box (128 bytes: one swizzle row)
constexpr int BOX = BN * BK * 2;  // bytes of one box of B (and of A's 128 rows)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on the H100
constexpr int kEncodeError = 10000;
constexpr float NEG = -__builtin_huge_valf();

enum Mode { kClosed = 0, kChain = 1, kTri = 2, kCount = 3 };
enum Tie { kFirst = 0, kMinIdx = 1 };  // p1_closed2_variant's argmax rule
constexpr int NO_COL = 0x7fffffff;     // the column of an empty tile state

struct Args {
  const __nv_bfloat16* A;  // (m, d) left rows
  const __nv_bfloat16* B;  // (n, d) the walked right columns
  float thr;
  int m, n, d, tile, cand_c;
  int stages;     // B ring depth (set by launch)
  int col_bufs;   // kTri: column-statistics buffers (set by launch)
  int col_off;    // global column id of B's first row
  float* v;       // (m, cand_c) running top-C values
  int* c;         // (m, cand_c) running top-C columns
  int* ship;      // kChain: (m, cand_c) output (kClosed masks c in place)
  int* counts;    // kClosed, kChain, kCount: (m,) outputs
  int* tmax;
  float* bound;
  int* meta;      // kChain state (m, 3): [counts, tmax, nfin]
  float* tb;      // kChain state (m,): per-tile drop bound
  float* rmeta;   // kTri (m, 8): [cnt, tmax, bound, nfin, 0, 0, 0, 0]
  int fut_start;  // kTri: first walked column of the column side
  int64_t n_fut;  // kTri: columns of the column side (statistics stride)
  int* st_cnt;    // kTri statistics, (m / 128, n_fut) each: count,
  int* st_s1;     //   sum of block-local rows, first row of the maximum,
  int* st_row;    //   maximum, second maximum
  float* st_v;
  float* st_v2;
};

// kTri: one sub-block's column statistics over the block's 128 rows.
struct ColStage {
  int cnt[BN];
  int s1[BN];
  uint32_t v2[BN];             // order bits of the second maximum (0: none)
  unsigned long long key[BN];  // order bits of the maximum << 32 | ~row
};
// shared bytes of kTri's column side: the buffers, then a counter each
__host__ __device__ constexpr int col_bytes(int bufs) {
  return bufs * static_cast<int>(sizeof(ColStage) + 8);
}

// ---- PTX wrappers -----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that never
// ends (2^26 polls of try_wait, tens of seconds) traps: the launch fails
// instead of hanging the card.  The loop lives in the PTX, so the compiler
// sees no divergent branch in front of the wgmma that follows.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      ".reg .u32 N1;\n"
      "mov.u32 N1, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "add.u32 N1, N1, 1;\n"
      "setp.gt.u32 P1, N1, 67108864;\n"
      "@P1 trap;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO 64 x 16 B); LBO is unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 f32, accumulator layout) (+)= A_tile (64 x 16) . B_tile^T.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the row side -------------------------------------------------------------
// Top-2 merge under the total order (value desc, index asc).
__device__ __forceinline__ void merge_top2(float& v, int& c, float& v2,
                                           float ov, int oc, float ov2) {
  const bool other_wins = ov > v || (ov == v && oc < c);
  if (other_wins) {
    v2 = fmaxf(ov2, v);
    v = ov;
    c = oc;
  } else {
    v2 = fmaxf(v2, ov);
  }
}

// The same merge written as the probe's argmax (TIE = kMinIdx): the
// maximum first, then the smallest column among the sides equal to it,
// then the maximum of what is left once that column is masked.
__device__ __forceinline__ void merge_minidx(float& v, int& c, float& v2,
                                             float ov, int oc, float ov2) {
  const float mx = fmaxf(v, ov);
  const int cm = min(v == mx ? c : NO_COL, ov == mx ? oc : NO_COL);
  v2 = fmaxf(c == cm ? v2 : v, oc == cm ? ov2 : ov);
  v = mx;
  c = cm;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Insert (p0, q0) and (p1, q1) (p0 >= p1; p1 = -inf when absent) into the
// row's sorted-desc top-C (v, c) -- the warp-wide form of _rank_insert2.
// Inlined: it runs while the next sub-block's wgmma writes its accumulator.
__device__ __forceinline__ void rank_insert2(float* v, int* c, int cand_c, float p0, int q0,
                             float p1, int q1, int lane) {
  constexpr int MAXJ = 8;  // cand_c <= 256 = 8 x 32
  int n0 = 0, n1 = 0;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int k = lane + 32 * j;
    if (k < cand_c) {
      const float vk = v[k];
      n0 += vk > p0;
      n1 += vk > p1;
    }
  }
  const int i0 = warp_sum(n0);
  const int i1 = warp_sum(n1) + 1;
  float nv[MAXJ];
  int nc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int k = lane + 32 * j;
    if (k < cand_c) {
      if (k == i0) {
        nv[j] = p0;
        nc[j] = q0;
      } else if (k == i1) {
        nv[j] = p1;
        nc[j] = q1;
      } else {
        const int src = k - (k > i0) - (k > i1);
        nv[j] = v[src];
        nc[j] = c[src];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int k = lane + 32 * j;
    if (k < cand_c) {
      v[k] = nv[j];
      c[k] = nc[j];
    }
  }
  __syncwarp();
}

// Per-thread state of its two rows (h = 0: row lane/4, h = 1: row lane/4+8
// of the warp's 16): the open tile's statistics over the thread's columns,
// and the running counters (identical in the 4 lanes of a quad).
struct Rows {
  int t_cnt[2], t_s1[2], t_cm[2];
  float t_vm[2], t_vm2[2];
  int counts[2], tmax[2], nfin[2];
  float tb[2];
};

__device__ __forceinline__ void open_tile(Rows& r) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.t_cnt[h] = 0;
    r.t_s1[h] = 0;
    r.t_cm[h] = NO_COL;
    r.t_vm[h] = NEG;
    r.t_vm2[h] = NEG;
  }
}

// ---- the column side (kTri) ---------------------------------------------------
// Order-preserving bits of a float (-0 taken as +0, so ties match ==) and
// back.  order_bits(-inf) = 0x007fffff, above the buffers' cleared 0.
__device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t u = __float_as_uint(x + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float order_value(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Fold the qualified score x at (block-local row, sub-block column) into
// the column's statistics.  The key of the maximum is (order bits, ~row),
// so the smaller row wins ties; every key that is not the final maximum
// reaches v2 exactly once: on arrival when a larger key is there, or from
// the atomic that displaces it.
__device__ __forceinline__ void col_hit(ColStage* cs, int col, int row, float x) {
  const uint32_t o = order_bits(x);
  const unsigned long long k =
      (static_cast<unsigned long long>(o) << 32) | static_cast<uint32_t>(~row);
  atomicAdd(&cs->cnt[col], 1);
  atomicAdd(&cs->s1[col], row);
  const unsigned long long old = atomicMax(&cs->key[col], k);
  atomicMax(&cs->v2[col], old > k ? o : static_cast<uint32_t>(old >> 32));
}

// Write column c of the sub-block's statistics to global memory at idx
// (count always, the rest where count > 0) and clear what was set.
__device__ __forceinline__ void col_flush(ColStage* cs, const Args& p,
                                          int64_t idx, int c) {
  const int cnt = cs->cnt[c];
  p.st_cnt[idx] = cnt;
  if (cnt > 0) {
    const unsigned long long k = cs->key[c];
    const uint32_t v2 = cs->v2[c];
    p.st_s1[idx] = cs->s1[c];
    p.st_row[idx] = static_cast<int>(~static_cast<uint32_t>(k));
    p.st_v[idx] = order_value(static_cast<uint32_t>(k >> 32));
    p.st_v2[idx] = v2 ? order_value(v2) : NEG;
    cs->cnt[c] = 0;
    cs->s1[c] = 0;
    cs->v2[c] = 0;
    cs->key[c] = 0;
  }
}

// Fold one sub-block's scores (accumulator layout) into the open tile:
// column tcol0 + 8j + 2q + e sits in acc[4j + 2h + e].  COL (kTri,
// future columns): each qualified score also goes to its column's
// statistics in `cs`; `rloc` is the block-local row of h = 0.  TIE =
// kMinIdx (p1_closed2_variant): the sub-block's maximum is mx, its column
// the smallest with a score equal to it, then the masked second maximum,
// merged into the tile by merge_minidx.
template <bool COL, int TIE = kFirst>
__device__ __forceinline__ void sub_block(Rows& r, const float (&acc)[64],
                                          float thr, int tcol0, int q,
                                          ColStage* cs, int rloc) {
  static_assert(TIE == kFirst || !COL, "the column side takes the first argmax");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = acc[2 * h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    if (TIE == kMinIdx && mx >= thr) {
      int cm = NO_COL;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * j + 2 * h + e];
          const int col = tcol0 + 8 * j + 2 * q + e;
          if (x >= thr) {
            ++r.t_cnt[h];
            r.t_s1[h] += col;
          }
          if (x == mx) cm = min(cm, col);
        }
      }
      float v2 = NEG;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * j + 2 * h + e];
          if (x >= thr && tcol0 + 8 * j + 2 * q + e != cm) v2 = fmaxf(v2, x);
        }
      }
      merge_minidx(r.t_vm[h], r.t_cm[h], r.t_vm2[h], mx, cm, v2);
    } else if (TIE == kFirst && mx >= thr) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * j + 2 * h + e];
          if (x >= thr) {
            const int col = tcol0 + 8 * j + 2 * q + e;
            ++r.t_cnt[h];
            r.t_s1[h] += col;
            if (x > r.t_vm[h]) {
              r.t_vm2[h] = r.t_vm[h];
              r.t_vm[h] = x;
              r.t_cm[h] = col;
            } else {
              r.t_vm2[h] = fmaxf(r.t_vm2[h], x);
            }
            if (COL) col_hit(cs, 8 * j + 2 * q + e, rloc + 8 * h, x);
          }
        }
      }
    }
  }
}

// kCount: the thread's qualified scores of the sub-block, into its
// per-thread counters (summed across the quad after the walk).
__device__ __forceinline__ void count_sub_block(Rows& r, const float (&acc)[64],
                                                float thr) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = acc[2 * h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    if (mx >= thr) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        r.counts[h] += (acc[4 * j + 2 * h] >= thr) + (acc[4 * j + 2 * h + 1] >= thr);
    }
  }
}

// Close the tile: merge across the quad, fold into the running counters,
// rank-insert the warp's rows that have a qualified column.  `row_lo` is
// the global row of h = 0 for this lane; `off` the tile's global column.
template <int TIE = kFirst>
__device__ __forceinline__ void close_tile(Rows& r, const Args& p, int row_lo,
                                          int off, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (TIE == kMinIdx) {
      // the quad's maximum, then its smallest column, then the rest's max
      float mx = r.t_vm[h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        r.t_cnt[h] += __shfl_xor_sync(0xffffffffu, r.t_cnt[h], o);
        r.t_s1[h] += __shfl_xor_sync(0xffffffffu, r.t_s1[h], o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      int cm = r.t_vm[h] == mx ? r.t_cm[h] : NO_COL;
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) cm = min(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      float v2 = r.t_cm[h] == cm ? r.t_vm2[h] : r.t_vm[h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) v2 = fmaxf(v2, __shfl_xor_sync(0xffffffffu, v2, o));
      r.t_vm[h] = mx;
      r.t_cm[h] = cm;
      r.t_vm2[h] = v2;
    } else {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        r.t_cnt[h] += __shfl_xor_sync(0xffffffffu, r.t_cnt[h], o);
        r.t_s1[h] += __shfl_xor_sync(0xffffffffu, r.t_s1[h], o);
        const float ov = __shfl_xor_sync(0xffffffffu, r.t_vm[h], o);
        const int oc = __shfl_xor_sync(0xffffffffu, r.t_cm[h], o);
        const float ov2 = __shfl_xor_sync(0xffffffffu, r.t_vm2[h], o);
        merge_top2(r.t_vm[h], r.t_cm[h], r.t_vm2[h], ov, oc, ov2);
      }
    }
    const int tcnt = r.t_cnt[h];
    r.counts[h] += tcnt;
    r.tmax[h] = max(r.tmax[h], tcnt);
    if (tcnt > 2) r.tb[h] = fmaxf(r.tb[h], r.t_vm2[h]);
    r.nfin[h] += (tcnt >= 1) + (tcnt == 2);

    unsigned hits = __ballot_sync(
        0xffffffffu, (lane & 3) == 0 && tcnt > 0 && row_lo + 8 * h < p.m);
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
      const int cnt = __shfl_sync(0xffffffffu, tcnt, src);
      const int s1 = __shfl_sync(0xffffffffu, r.t_s1[h], src);
      const float p0 = __shfl_sync(0xffffffffu, r.t_vm[h], src);
      const int c0 = __shfl_sync(0xffffffffu, r.t_cm[h], src);
      const float v2 = __shfl_sync(0xffffffffu, r.t_vm2[h], src);
      const int row = row_lo - (lane >> 2) + (src >> 2) + 8 * h;
      const bool have2 = cnt == 2;
      const int64_t g = static_cast<int64_t>(row) * p.cand_c;
      rank_insert2(p.v + g, p.c + g, p.cand_c, p0, c0 + off, have2 ? v2 : NEG,
                   (have2 ? s1 - c0 : 0) + off, lane);
    }
  }
  open_tile(r);
}

// The epilogue of sub-block sb, from its accumulator; `row_lo` is this
// lane's global row of h = 0, `rloc` the block-local one.  kTri, future
// columns: the column side into buffer sb % col_bufs; the last of the 8
// consumer warps to finish the sub-block (a counter per buffer) flushes
// it, so no warp waits for another.  A warp cannot reach the buffer's next
// sub-block before that flush: it would need a B stage that the producer
// loads only after every warp has released a stage issued after its
// epilogue of sb, and launch gives col_bufs * (d / 64) > stages.
template <int MODE, int TIE>
__device__ __forceinline__ void epilogue(Rows& r, const float (&acc)[64],
                                         const Args& p, int sb, int row_lo,
                                         int rloc, int lane, ColStage* cst) {
  if (MODE == kCount) {
    count_sub_block(r, acc, p.thr);
    return;
  }
  const int col0 = sb * BN;
  const int tcol0 = col0 % p.tile;
  const bool col_side = MODE == kTri && col0 >= p.fut_start;
  const int buf = col_side ? sb % p.col_bufs : 0;
  ColStage* cs = col_side ? cst + buf : nullptr;
  if (col_side)
    sub_block<true>(r, acc, p.thr, tcol0, lane & 3, cs, rloc);
  else
    sub_block<false, TIE>(r, acc, p.thr, tcol0, lane & 3, nullptr, rloc);
  if ((col0 + BN) % p.tile == 0)
    close_tile<TIE>(r, p, row_lo, p.col_off + col0 - tcol0, lane);
  if (col_side) {
    int* done = reinterpret_cast<int*>(cst + p.col_bufs) + 2 * buf;
    __syncwarp();  // the warp's atomics before lane 0's count
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(done, 1) == 7;
      __threadfence_block();
    }
    if (__shfl_sync(0xffffffffu, last, 0)) {
      __syncwarp();
      const int64_t idx =
          static_cast<int64_t>(blockIdx.x) * p.n_fut + (col0 - p.fut_start);
      for (int c = lane; c < BN; c += 32) col_flush(cs, p, idx + c, c);
      if (lane == 0) *done = 0;
      __syncwarp();  // the clears before lane 0's next empty-barrier arrive
    }
  }
}

// ---- the kernel -----------------------------------------------------------------
struct Ring {
  uint32_t b0;     // shared address of stage 0
  uint32_t full0;  // shared address of full[0]; empty[s] = full0 + 8 * (S + s)
  int stages;
  int st = 0;
  uint32_t ph = 0;
  int prev = -1;
  __device__ __forceinline__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return full0 + 8 * (stages + s);
  }
  __device__ __forceinline__ void advance() {
    prev = st;
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// Issue the 4 wgmmas of B stage `ring.st` (k block kb) into acc, as one
// commit group; then wait for the previous group and release its stage.
// A's k blocks lie ROWS x 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ void mma_stage(float (&acc)[64], Ring& ring,
                                          uint32_t a_wg, int kb, int lane) {
  mbar_wait(ring.full(ring.st), ring.ph);
  const uint32_t a = a_wg + kb * (ROWS * BK * 2);
  const uint32_t b = ring.b0 + ring.st * BOX;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    wgmma_m64n128k16(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k),
                     (kb | k) != 0);
  wgmma_commit();
  fence_regs(acc);
  wgmma_wait<1>();
  if (ring.prev >= 0 && lane == 0) mbar_arrive(ring.empty(ring.prev));
  ring.advance();
}

// Threads of a block of ROWS left rows: a consumer warpgroup per 64 rows,
// then the producer warpgroup.
__host__ __device__ constexpr int threads(int rows) { return 2 * rows + 128; }

template <int MODE, int ROWS = BM, int TIE = kFirst>
__global__ void __launch_bounds__(threads(ROWS), 1)
    scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, const Args p) {
  static_assert(ROWS == BM || ROWS == 64, "a block holds 128 or 64 rows");
  static_assert((ROWS == BM && TIE == kFirst) || MODE == kClosed,
                "the switches are kClosed's");
  constexpr int CWG = ROWS / 64;     // consumer warpgroups
  constexpr int NTR = threads(ROWS);
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes must sit on 1024-byte boundaries.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nkb = p.d / BK;
  const int S = p.stages;
  const uint32_t a_s = base;
  const uint32_t b_s = a_s + nkb * (ROWS * BK * 2);
  const uint32_t bars = b_s + S * BOX;  // full[S], empty[S], a_full
  const uint32_t a_full = bars + 16 * S;
  // kTri: the column-statistics buffers, after the barriers' 256 bytes
  ColStage* cst =
      reinterpret_cast<ColStage*>(smem_raw + (bars + 256 - smem_u32(smem_raw)));
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int n_sub = p.n / BN;

  if (MODE == kTri) {
    for (int i = tid; i < col_bytes(p.col_bufs) / 4; i += NTR)
      reinterpret_cast<uint32_t*>(cst)[i] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);            // producer's expect_tx
      mbar_init(bars + 8 * (S + s), 4 * CWG);  // one arrival per consumer warp
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role, broadcast from lane 0 so that the compiler sees it is
  // warp-uniform (wgmma in a possibly divergent path is serialized).
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == CWG) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    if (CWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CWG * 128) {
      mbar_expect_tx(a_full, nkb * (ROWS * BK * 2));
      for (int kb = 0; kb < nkb; ++kb)
        tma_load(a_s + kb * (ROWS * BK * 2), &tm_a, kb * BK, row0, a_full);
      int st = 0;
      uint32_t ph = 0;
      for (int sb = 0; sb < n_sub; ++sb) {
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(bars + 8 * (S + st), ph ^ 1);
          mbar_expect_tx(bars + 8 * st, BOX);
          tma_load(b_s + st * BOX, &tm_b, kb * BK, sb * BN, bars + 8 * st);
          if (++st == S) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 --------------------
    if (CWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = role;
    const int lane = tid & 31;
    const int wrow = row0 + wg * 64 + ((tid & 127) >> 5) * 16;  // warp's row 0
    const int row_lo = wrow + (lane >> 2);
    const int rloc = row_lo - row0;
    const int cand_c = p.cand_c;

    if (MODE == kClosed || MODE == kTri) {
      for (int i = lane; i < 16 * cand_c; i += 32) {
        if (wrow + i / cand_c < p.m) {
          p.v[static_cast<int64_t>(wrow) * cand_c + i] = NEG;
          p.c[static_cast<int64_t>(wrow) * cand_c + i] = 0;
        }
      }
      __syncwarp();
    }
    Rows r;
    open_tile(r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row_lo + 8 * h;
      if (MODE == kChain && gr < p.m) {
        r.counts[h] = p.meta[3 * static_cast<int64_t>(gr)];
        r.tmax[h] = p.meta[3 * static_cast<int64_t>(gr) + 1];
        r.nfin[h] = p.meta[3 * static_cast<int64_t>(gr) + 2];
        r.tb[h] = p.tb[gr];
      } else {
        r.counts[h] = 0;
        r.tmax[h] = 0;
        r.nfin[h] = 0;
        r.tb[h] = NEG;
      }
    }

    Ring ring{b_s, bars, S};
    const uint32_t a_wg = a_s + wg * 64 * 128;  // this warpgroup's 64 rows
    float acc0[64], acc1[64];
    mbar_wait(a_full, 0);

    // sub-block 0 into acc0; then per pair of sub-blocks: issue the next
    // sub-block's first stage, finish and consume the current one, issue
    // the rest (n_sub is even: n is a multiple of tile, tile of 256).
    for (int kb = 0; kb < nkb; ++kb) mma_stage<ROWS>(acc0, ring, a_wg, kb, lane);
    for (int sb = 0;; sb += 2) {
      mma_stage<ROWS>(acc1, ring, a_wg, 0, lane);  // sub-block sb is complete
      fence_regs(acc0);
      epilogue<MODE, TIE>(r, acc0, p, sb, row_lo, rloc, lane, cst);
      for (int kb = 1; kb < nkb; ++kb) mma_stage<ROWS>(acc1, ring, a_wg, kb, lane);
      if (sb + 2 == n_sub) break;
      mma_stage<ROWS>(acc0, ring, a_wg, 0, lane);  // sub-block sb + 1 is complete
      fence_regs(acc1);
      epilogue<MODE, TIE>(r, acc1, p, sb + 1, row_lo, rloc, lane, cst);
      for (int kb = 1; kb < nkb; ++kb) mma_stage<ROWS>(acc0, ring, a_wg, kb, lane);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(ring.empty(ring.prev));
    fence_regs(acc1);
    epilogue<MODE, TIE>(r, acc1, p, n_sub - 1, row_lo, rloc, lane, cst);

    if (MODE == kCount) {  // the per-thread counts, summed across the quad
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1)
          r.counts[h] += __shfl_xor_sync(0xffffffffu, r.counts[h], o);
        const int gr = row_lo + 8 * h;
        if ((lane & 3) == 0 && gr < p.m) p.counts[gr] = r.counts[h];
      }
      return;
    }

    // ---- outputs: the warp's 16 rows (kTri keeps v and c as they are) ---
    for (int i = lane; MODE != kTri && i < 16 * cand_c; i += 32) {
      if (wrow + i / cand_c >= p.m) break;
      const int64_t g = static_cast<int64_t>(wrow) * cand_c + i;
      if (MODE == kClosed) {
        if (!(p.v[g] > NEG)) p.c[g] = -1;
      } else {
        p.ship[g] = p.v[g] > NEG ? p.c[g] : -1;
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row_lo + 8 * h;
        if (gr >= p.m) continue;
        if (MODE == kTri) {
          float* rm = p.rmeta + 8 * static_cast<int64_t>(gr);
          rm[0] = static_cast<float>(r.counts[h]);
          rm[1] = static_cast<float>(r.tmax[h]);
          rm[2] = r.tb[h];
          rm[3] = static_cast<float>(r.nfin[h]);
          for (int k = 4; k < 8; ++k) rm[k] = 0.f;
          continue;
        }
        const int64_t g = static_cast<int64_t>(gr) * cand_c;
        const float trunc = r.nfin[h] > cand_c ? p.v[g + cand_c - 1] : NEG;
        p.counts[gr] = r.counts[h];
        p.tmax[gr] = r.tmax[h];
        p.bound[gr] = fmaxf(r.tb[h], trunc);
        if (MODE == kChain) {
          p.meta[3 * static_cast<int64_t>(gr)] = r.counts[h];
          p.meta[3 * static_cast<int64_t>(gr) + 1] = r.tmax[h];
          p.meta[3 * static_cast<int64_t>(gr) + 2] = r.nfin[h];
          p.tb[gr] = r.tb[h];
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// (rows, d) bf16, row-major, read in boxes of box_rows rows x 64 k with the
// 128-byte swizzle; rows past the end read as zeros.
inline int make_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t d,
                    int box_rows = BN) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// Launch one block per ROWS rows on `stream`; returns the cudaError_t (or
// kEncodeError + CUresult when a TMA descriptor cannot be built).
template <int MODE, int ROWS = BM, int TIE = kFirst>
inline int launch(Args p, void* stream) {
  CUtensorMap tm_a, tm_b;
  int e = make_map(&tm_a, p.A, p.m, p.d, ROWS);
  if (e == 0) e = make_map(&tm_b, p.B, p.n, p.d);
  if (e != 0) return e;
  const int nkb = p.d / BK;
  const int a_bytes = nkb * ROWS * BK * 2;
  const int room = SMEM_LIMIT - 1024 - 256 - a_bytes;  // alignment, barriers
  p.stages = room / BOX < MAX_STAGES ? room / BOX : MAX_STAGES;
  p.col_bufs = 0;
  if (MODE == kTri) {
    // col_bufs * nkb > stages (see epilogue), with as deep a ring as fits
    for (;; --p.stages) {
      p.col_bufs = p.stages / nkb + 1;
      if (p.stages * BOX + col_bytes(p.col_bufs) <= room) break;
    }
  }
  const size_t smem = 1024 + a_bytes + static_cast<size_t>(p.stages) * BOX + 256 +
                      col_bytes(p.col_bufs);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MODE, ROWS, TIE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((p.m + ROWS - 1) / ROWS);
  scan_kernel<MODE, ROWS, TIE>
      <<<blocks, threads(ROWS), smem, static_cast<cudaStream_t>(stream)>>>(tm_a, tm_b, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace p1h
