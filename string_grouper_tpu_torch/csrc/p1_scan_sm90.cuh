// The fused phase-1 scan for Hopper (sm_90a), built on TMA, mbarriers and
// wgmma, shared by six kernels:
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
//   p1_fused_topk.cu     one pass over the whole right corpus with the
//                        tile's top kt (4, 8, 16 or 32) in place of the
//                        closed-form top 2: escalation's re-match (kTopK)
// It replaces the Pallas kernels p1_fused_closed2, p1_fused_chain and the
// scan of p1_tri_fused of the JAX package
// (string_grouper_tpu/ops/pallas_kernels.py:117-179, :275-358 and
// :631-726; bodies _p1_body :47-114, _p1_chain_body :183-257 and
// _p1_tri_body :414-623), and the A/B probes mm_floor and variant of
// benchmarks/ab_p1_epilogue.py (:65-88, body _mm_body :56-62; :160-200,
// bodies _p1_body_minidx :92-157 and _p1_body), and the XLA tile body
// _ub_topk_scan at 4 <= kt <= 32 (string_grouper_tpu/ops/matcher.py:701).
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
//   loads.  A's 128 x d rows arrive once (d <= 512; wider A streams, see
//   below), as d/64 boxes of 128 rows x 64 k
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
// * kTopK (kTopK + j: kt = 4 << j, a compile-time width): per row and tile
//   the qualified count, tmax, and the tile's top kt by (value desc, first
//   column on ties), rank-inserted into the running top-C where a new
//   entry goes after equal old ones; the drop bound is the kt-th value of
//   a tile whose count exceeds kt, or what leaves the top-C.  The product
//   is kClosed's (same ring, same k order: a row's scores are phase 1's
//   bits), A resident only.  Escalation sends rows here bucketed by phase
//   1's tmax, so within a job a tile of a row rarely holds more than kt
//   qualified columns: the epilogue is a sparse append.  Each row has kt
//   (value, column) slots in shared memory (BM x kt x 8 bytes: 32 KB at kt
//   = 32, two of the ring's 16 KB stages); a sub-block whose warp has no
//   qualified score costs kClosed's max and compare, plus one vote.  Else
//   the quad counts its qualified scores, scans the counts, and each lane
//   appends its own at its offset (a lane's scores picked from the
//   accumulator by selects, so it stays in registers).  A tile that would
//   overflow its kt slots takes the exact path: the quad's lanes in turn
//   push their scores through a replace-the-worst insert.  At the tile's
//   end the warp merges each row with a hit, row after row, into its
//   running top-C in global memory (L2-resident): the new entries' ranks
//   among themselves by shuffles, then the row's finite prefix walked in
//   32-slot chunks from its end (each old entry moves down by the new
//   entries above it, each new one lands after the old entries >= it),
//   stopping at the first chunk that starts at or above the new maximum.
//   So a merge costs the slots below the new maximum, not C: any C a
//   multiple of 8.  A job of few rows would leave most SMs idle (4096
//   rows are 32 blocks on 132 SMs), so the columns split too: block
//   (x, y) walks split y of gridDim.y contiguous tile ranges and writes its
//   own running top-C and counters (partials; nothing is initialised, only
//   each list's finite prefix is ever read), and p1_fused_topk.cu's merge
//   joins the splits in order.  Splits at tile boundaries, merged as a
//   stable sort in split order, are bitwise one pass.
// * Streamed A (STREAM_A, kClosed / kChain / kTri at 128 rows): A's 128
//   resident rows take d * 256 bytes, 256 KB at d = 1024, more than a
//   block has.  Past d = RESIDENT_MAX_D (512: 128 KB of A beside a 6-stage
//   ring; 640 would leave 4 stages, 768 two) A streams through the ring,
//   and nothing of it stays resident.  Carried beside one B box per
//   stage, A would be read from L2 once per 128 columns: 32 KB per 1 M
//   multiply-adds, twice the resident scan's 16 KB, and the scan bound by
//   L2 reads.  Two things bring it back to 16 KB:
//   - Sub-block pairs.  A stage holds k block kb of A's box and of B's
//     boxes for sub-blocks sb and sb + 1, 48 KB (4 stages fit).  Each
//     consumer warpgroup issues one m64n256k16 chain per stage from the
//     one A descriptor: its first 64 accumulator registers are sub-block
//     sb's (acc0), the last 64 sb + 1's (acc1), laid out as two
//     m64n128k16 would lay them.  After the pair's last k block it runs
//     epilogue(sb), then epilogue(sb + 1): within each accumulator the k
//     blocks run in ascending order, so every sum is the resident scan's
//     f32 bits and the rank inserts come in the same order
//     (p1h_force_stream_a checks that at d <= 512).  This gives up the
//     overlap of one sub-block's epilogue with the next one's product:
//     both accumulators are busy on the pair.
//   - A cluster of 2 row-neighbour blocks (cluster_of).  Blocks 2c and 2c + 1
//     walk the same columns in the same order.  Each producer loads its
//     own A box and one of the stage's two B boxes with
//     .multicast::cluster into both blocks: rank 0 sub-block sb's, rank 1
//     sb + 1's.  Each full barrier expects the stage's 48 KB; each empty
//     barrier counts the consumer warps of both blocks (16 arrivals, 8 of
//     them remote), so no producer refills a stage that its peer still
//     reads.  L2 reads: 32 KB per 2 M multiply-adds.
//   Where trouble lies, and what the code does about it:
//   - Ragged m and odd block counts: the grid is rounded up to whole
//     clusters; a block whose rows all lie past m still walks every stage
//     (waits, issues its wgmma, releases, loads its multicast half) but
//     loads no A box and runs no epilogue; every output keeps its
//     row < m guard.  A peer that hangs traps in mbar_wait.
//   - Co-scheduling: a cluster that cannot be placed is a launch error,
//     returned as such; nothing falls back to another stage layout.
//     plan_info (each library's p1h_plan) reports
//     cudaOccupancyMaxActiveClusters.
//   - Barrier init: fence.mbarrier_init.release.cluster, then a cluster
//     barrier before the first multicast; another before exit, so that no
//     block leaves while its peer can still arrive on its barriers.
//   - kTri's column buffers: see epilogue (the rule differs from the
//     resident scan's).  The statistics stay per block (blockIdx.x is the
//     row block under a cluster too).
//
// Left for later: wave quantization (one block of 128 rows per SM: 576
// blocks on 132 SMs at the 663k segment, 4.36 waves); thread-block
// clusters with TMA multicast of B for the resident scan (d <= 512),
// which is not bound by B's L2 reads (the 64-row probe of the variant).

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
constexpr int RESIDENT_MAX_D = 512;  // widest A kept resident (else streamed)
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on the H100
constexpr int kEncodeError = 10000;
constexpr float NEG = -__builtin_huge_valf();

enum Mode { kClosed = 0, kChain = 1, kTri = 2, kCount = 3, kTopK = 4 };
// kTopK + j is the top-kt epilogue at kt = 4 << j (j = 0..3)
__host__ __device__ constexpr bool is_topk(int mode) { return mode >= kTopK; }
__host__ __device__ constexpr int topk_kt(int mode) {
  return is_topk(mode) ? 4 << (mode - kTopK) : 0;
}
__host__ __device__ constexpr int topk_mode(int kt) {
  return kTopK + (kt >= 32 ? 3 : kt >= 16 ? 2 : kt >= 8 ? 1 : 0);
}
// shared bytes of kTopK's tile buffers: BM rows of kt values and columns
__host__ __device__ constexpr int topk_bytes(int mode) { return BM * topk_kt(mode) * 8; }
enum Tie { kFirst = 0, kMinIdx = 1 };  // p1_closed2_variant's argmax rule
constexpr int NO_COL = 0x7fffffff;     // the column of an empty tile state

struct Args {
  const __nv_bfloat16* A;  // (m, d) left rows
  const __nv_bfloat16* B;  // (n, d) the walked right columns
  float thr;
  int m, n, d, tile, cand_c;
  int stages;     // ring depth (set by launch)
  int col_bufs;   // kTri: column-statistics buffers (set by launch)
  int col_off;    // global column id of B's first row
  float* v;       // (m, cand_c) running top-C values
  int* c;         // (m, cand_c) running top-C columns
  int* ship;      // kChain: (m, cand_c) output (kClosed masks c in place)
  int* counts;    // kClosed, kChain, kCount: (m,) outputs
  int* tmax;
  float* bound;
  int* meta;      // kChain state (m, 3): [counts, tmax, nfin]
  float* tb;      // kChain state (m,): per-tile drop bound (kTopK: the
                  //   splits' [counts, tmax, nfin] and bounds in meta, tb)
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

// ---- clusters (the streamed scan) ------------------------------------------
// The same box into the same shared offset of every block in `mask`, each
// block's barrier at `bar` counting its bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   int k, int row, uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar),
        "h"(mask)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Arrive on the barrier at shared offset `bar` of the cluster's block `cta`.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar), "r"(cta) : "memory");
}
// Every thread of the cluster's blocks (not .aligned: callers may diverge).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
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

// (d0 | d1) (64 x 256 f32: d0 columns 0-127, d1 128-255, each in the
// m64n128k16 layout) (+)= A_tile (64 x 16) . B_tile^T, B's 256 rows two
// boxes of 128 back to back.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d0)[64], float (&d1)[64],
                                                 uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d0[32]), "+f"(d0[33]), "+f"(d0[34]), "+f"(d0[35]), "+f"(d0[36]), "+f"(d0[37]), "+f"(d0[38]), "+f"(d0[39]),
        "+f"(d0[40]), "+f"(d0[41]), "+f"(d0[42]), "+f"(d0[43]), "+f"(d0[44]), "+f"(d0[45]), "+f"(d0[46]), "+f"(d0[47]),
        "+f"(d0[48]), "+f"(d0[49]), "+f"(d0[50]), "+f"(d0[51]), "+f"(d0[52]), "+f"(d0[53]), "+f"(d0[54]), "+f"(d0[55]),
        "+f"(d0[56]), "+f"(d0[57]), "+f"(d0[58]), "+f"(d0[59]), "+f"(d0[60]), "+f"(d0[61]), "+f"(d0[62]), "+f"(d0[63]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31]),
        "+f"(d1[32]), "+f"(d1[33]), "+f"(d1[34]), "+f"(d1[35]), "+f"(d1[36]), "+f"(d1[37]), "+f"(d1[38]), "+f"(d1[39]),
        "+f"(d1[40]), "+f"(d1[41]), "+f"(d1[42]), "+f"(d1[43]), "+f"(d1[44]), "+f"(d1[45]), "+f"(d1[46]), "+f"(d1[47]),
        "+f"(d1[48]), "+f"(d1[49]), "+f"(d1[50]), "+f"(d1[51]), "+f"(d1[52]), "+f"(d1[53]), "+f"(d1[54]), "+f"(d1[55]),
        "+f"(d1[56]), "+f"(d1[57]), "+f"(d1[58]), "+f"(d1[59]), "+f"(d1[60]), "+f"(d1[61]), "+f"(d1[62]), "+f"(d1[63])
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

// ---- the top-kt epilogue (kTopK) ---------------------------------------------
// Score i (0..31) of the thread's row h, sub-block column 8 (i / 2) + 2q +
// i % 2, at a run-time i: selects, so that acc stays in registers.
__device__ __forceinline__ float pick(const float (&acc)[64], int h, int i) {
  float x = acc[2 * h];
#pragma unroll
  for (int t = 1; t < 32; ++t) x = t == i ? acc[4 * (t >> 1) + 2 * h + (t & 1)] : x;
  return x;
}

// The slot of a full row buffer's last entry under (value desc, column asc).
template <int KT>
__device__ __forceinline__ int topk_worst(const float* bv, const int* bc) {
  int w = 0;
#pragma unroll 1
  for (int t = 1; t < KT; ++t)
    if (bv[t] < bv[w] || (bv[t] == bv[w] && bc[t] > bc[w])) w = t;
  return w;
}

// The exact path of a tile that overflows its kt slots: this lane's
// qualified scores (bits of mask) into the row buffer (bv, bc) holding n
// entries: appended while there is room, then each replaces the worst
// entry when it beats it.  The kt best of all pushed scores stay, in any
// order of the pushes.
template <int KT>
__device__ __forceinline__ void topk_push(float* bv, int* bc, int n, unsigned mask,
                                          const float (&acc)[64], int h, int col0) {
  int w = n == KT ? topk_worst<KT>(bv, bc) : 0;
  while (mask) {
    const int i = __ffs(mask) - 1;
    mask &= mask - 1;
    const float x = pick(acc, h, i);
    const int col = col0 + 8 * (i >> 1) + (i & 1);
    if (n < KT) {
      bv[n] = x;
      bc[n] = col;
      if (++n == KT) w = topk_worst<KT>(bv, bc);
    } else if (x > bv[w] || (x == bv[w] && col < bc[w])) {
      bv[w] = x;
      bc[w] = col;
      w = topk_worst<KT>(bv, bc);
    }
  }
}

// One sub-block into the rows' tile buffers (bv, bc: BM rows of KT slots;
// rloc the block-local row of h = 0).  r.t_cnt[h] is the tile's qualified
// count so far, the same in the quad's 4 lanes.
template <int KT>
__device__ __forceinline__ void topk_sub_block(Rows& r, const float (&acc)[64],
                                               float thr, int tcol0, int lane,
                                               float* bv, int* bc, int rloc) {
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = acc[2 * h];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    if (!__any_sync(0xffffffffu, mx >= thr)) continue;
    unsigned mask = 0;
    if (mx >= thr) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mask |= static_cast<unsigned>(acc[4 * (i >> 1) + 2 * h + (i & 1)] >= thr) << i;
    }
    // the quad's counts, scanned: this lane's first slot and the quad's total
    const int nq = __popc(mask);
    int incl = nq;
    int t = __shfl_up_sync(0xffffffffu, incl, 1, 4);
    if (q >= 1) incl += t;
    t = __shfl_up_sync(0xffffffffu, incl, 2, 4);
    if (q >= 2) incl += t;
    const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
    const int fill = r.t_cnt[h];
    const int start = fill + incl - nq;
    float* rv = bv + (rloc + 8 * h) * KT;
    int* rc = bc + (rloc + 8 * h) * KT;
    const int col0 = tcol0 + 2 * q;
    const bool over = fill + total > KT;
    if (!over) {
      for (int s = start; mask; ++s) {
        const int i = __ffs(mask) - 1;
        mask &= mask - 1;
        rv[s] = pick(acc, h, i);
        rc[s] = col0 + 8 * (i >> 1) + (i & 1);
      }
    }
    if (__any_sync(0xffffffffu, over)) {
      __syncwarp();  // the slots other lanes stored before this read them
      for (int src = 0; src < 4; ++src) {  // the quad's lanes in turn
        if (over && q == src) topk_push<KT>(rv, rc, min(start, KT), mask, acc, h, col0);
        __syncwarp();
      }
    }
    r.t_cnt[h] = fill + total;
  }
}

// Close the tile: the running counters, then, row after row, each of the
// warp's rows with a qualified column merged into its running top-C.
// `off` is the tile's global column.
template <int KT>
__device__ __forceinline__ void topk_close(Rows& r, const Args& p, int row_lo, int off,
                                           int lane, const float* bv, const int* bc,
                                           int rloc) {
  __syncwarp();  // the quads' appends before other lanes read them
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tcnt = r.t_cnt[h];
    const int had = r.nfin[h];
    r.counts[h] += tcnt;
    r.tmax[h] = max(r.tmax[h], tcnt);
    r.nfin[h] += min(tcnt, KT);
    unsigned hits = __ballot_sync(
        0xffffffffu, (lane & 3) == 0 && tcnt > 0 && row_lo + 8 * h < p.m);
    while (hits) {
      const int src = __ffs(hits) - 1;
      hits &= hits - 1;
      const int cnt = __shfl_sync(0xffffffffu, tcnt, src);
      const int n = min(cnt, KT);
      const int full = min(__shfl_sync(0xffffffffu, had, src), p.cand_c);
      const int dr = (src >> 2) - (lane >> 2) + 8 * h;
      // lane j < n holds the tile's entry j; rj its rank among them
      float pj = NEG;
      int qj = 0;
      if (lane < n) {
        pj = bv[(rloc + dr) * KT + lane];
        qj = bc[(rloc + dr) * KT + lane] + off;
      }
      int rj = 0;
      float pmax = NEG, pmin = -NEG;
      for (int i = 0; i < n; ++i) {
        const float pi = __shfl_sync(0xffffffffu, pj, i);
        const int qi = __shfl_sync(0xffffffffu, qj, i);
        rj += pi > pj || (pi == pj && qi < qj);
        pmax = fmaxf(pmax, pi);
        pmin = fminf(pmin, pi);
      }
      if (cnt > KT && (lane >> 2) == (src >> 2)) r.tb[h] = fmaxf(r.tb[h], pmin);
      // this split's list of the row
      const int64_t g =
          (static_cast<int64_t>(blockIdx.y) * p.m + row_lo + dr) * p.cand_c;
      float* v = p.v + g;
      int* c = p.c + g;
      // the finite prefix [0, full) from its end, 32 slots at a time: each
      // old entry moves down by the new entries above it; lane j counts
      // the old entries >= p_j
      int ahead = 0;
      for (int base = (full - 1) & ~31; base >= 0; base -= 32) {
        const int k = base + lane;
        const bool in = k < full;
        const float vk = in ? v[k] : NEG;
        const int ck = in ? c[k] : 0;
        int shift = 0;
        for (int i = 0; i < n; ++i) {
          const float pi = __shfl_sync(0xffffffffu, pj, i);
          shift += pi > vk;
          const unsigned ge = __ballot_sync(0xffffffffu, in && vk >= pi);
          if (lane == i) ahead += __popc(ge);
        }
        __syncwarp();
        if (in && shift > 0 && k + shift < p.cand_c) {
          v[k + shift] = vk;
          c[k + shift] = ck;
        }
        __syncwarp();
        // every slot below base holds a value >= v[base]: none moves
        if (__shfl_sync(0xffffffffu, vk, 0) >= pmax) {
          ahead += base;
          break;
        }
      }
      if (lane < n && ahead + rj < p.cand_c) {
        v[ahead + rj] = pj;
        c[ahead + rj] = qj;
      }
      __syncwarp();
    }
  }
  open_tile(r);
}

// The walk's end: this split's counters of the lane's rows, [counts,
// tmax, nfin] into meta and the tile drop bound into tb.
__device__ __forceinline__ void topk_split_out(const Rows& r, const Args& p, int row_lo,
                                               int lane) {
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row_lo + 8 * h;
    if (gr >= p.m) continue;
    const int64_t g = static_cast<int64_t>(blockIdx.y) * p.m + gr;
    p.meta[3 * g] = r.counts[h];
    p.meta[3 * g + 1] = r.tmax[h];
    p.meta[3 * g + 2] = r.nfin[h];
    p.tb[g] = r.tb[h];
  }
}

// kTopK: the first sub-block of split y of gridDim.y (whole tiles each).
__device__ __forceinline__ int split_sb(const Args& p, int y) {
  const int nt = p.n / p.tile;
  return (nt * y / static_cast<int>(gridDim.y)) * (p.tile / BN);
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
// sub-block before that flush: it would need a ring stage that the
// producer loads only after every warp has released a stage issued after
// its epilogue of sb.  Resident A (a stage holds one k block of one
// sub-block): launch gives col_bufs * nkb > stages.  Streamed A (a stage
// holds one k block of a pair; a warp in the epilogues of pair P has
// released every stage up to P's last, nkb (P + 1) - 1, and no later
// one): a warp can finish the stages of pair P' while a slow one is in
// pair P only if (P' - P) nkb <= stages, and sub-blocks sb and
// sb + col_bufs lie at least floor(col_bufs / 2) pairs apart, so launch
// gives floor(col_bufs / 2) * nkb > stages.  Under a cluster each
// producer also waits for the peer's warps: that only holds it back.
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
  if constexpr (is_topk(MODE)) {
    constexpr int KT = topk_kt(MODE);
    float* bv = reinterpret_cast<float*>(cst);  // kTopK's tile buffers
    int* bc = reinterpret_cast<int*>(bv + BM * KT);
    topk_sub_block<KT>(r, acc, p.thr, tcol0, lane, bv, bc, rloc);
    if ((col0 + BN) % p.tile == 0)
      topk_close<KT>(r, p, row_lo, p.col_off + col0 - tcol0, lane, bv, bc, rloc);
    return;
  }
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

// Bytes of one ring stage: B's box; with STREAM_A A's box, then B's boxes
// of a sub-block pair.
__host__ __device__ constexpr int stage_bytes(bool stream_a) {
  return stream_a ? 3 * BOX : BOX;
}

// Issue the 4 wgmmas of ring stage `ring.st` (k block kb) into acc, as one
// commit group; then wait for the previous group and release its stage.
// `a_wg` is the warpgroup's rows of k block 0 in resident A, k blocks lie
// ROWS x 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ void mma_stage(float (&acc)[64], Ring& ring,
                                          uint32_t a_wg, int kb, int lane) {
  mbar_wait(ring.full(ring.st), ring.ph);
  const uint32_t stage = ring.b0 + ring.st * stage_bytes(false);
  const uint32_t a = a_wg + kb * (ROWS * BK * 2);
  const uint32_t b = stage;
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

// Streamed A: release stage s in both blocks of the cluster (the same
// offset; each producer's empty barrier counts both blocks' warps).
__device__ __forceinline__ void release(const Ring& ring, int s, int lane) {
  if (lane != 0) return;
  mbar_arrive_cluster(ring.empty(s), 0);
  mbar_arrive_cluster(ring.empty(s), 1);
}

// Streamed A: the 4 m64n256k16 of ring stage `ring.st` (k block kb of a
// sub-block pair) into (acc0 | acc1), as one commit group; then wait for
// the previous group and release its stage.  `a_wg` is the warpgroup's
// offset in the stage's A box; B's two boxes follow A's.
__device__ __forceinline__ void mma_pair(float (&acc0)[64], float (&acc1)[64],
                                         Ring& ring, uint32_t a_wg, int kb, int lane) {
  mbar_wait(ring.full(ring.st), ring.ph);
  const uint32_t stage = ring.b0 + ring.st * stage_bytes(true);
  const uint32_t a = stage + a_wg;
  const uint32_t b = stage + BOX;
  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
    wgmma_m64n256k16(acc0, acc1, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k),
                     (kb | k) != 0);
  wgmma_commit();
  fence_regs(acc0);
  fence_regs(acc1);
  wgmma_wait<1>();
  if (ring.prev >= 0) release(ring, ring.prev, lane);
  ring.advance();
}

// Threads of a block of ROWS left rows: a consumer warpgroup per 64 rows,
// then the producer warpgroup.
__host__ __device__ constexpr int threads(int rows) { return 2 * rows + 128; }

// Blocks of a cluster: 2 row blocks when A streams (the pair's B boxes
// multicast to both), else 1.
__host__ __device__ constexpr int cluster_of(bool stream_a) { return stream_a ? 2 : 1; }

template <int MODE, int ROWS = BM, int TIE = kFirst, bool STREAM_A = false>
__global__ void __launch_bounds__(threads(ROWS), 1)
    scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, const Args p) {
  static_assert(ROWS == BM || ROWS == 64, "a block holds 128 or 64 rows");
  static_assert((ROWS == BM && TIE == kFirst) || MODE == kClosed,
                "the switches are kClosed's");
  static_assert(!STREAM_A || (ROWS == BM && TIE == kFirst && MODE != kCount),
                "A streams in kClosed, kChain and kTri at 128 rows");
  static_assert(!is_topk(MODE) || !STREAM_A, "kTopK keeps A resident");
  constexpr int CL = cluster_of(STREAM_A);
  constexpr int CWG = ROWS / 64;     // consumer warpgroups
  constexpr int NTR = threads(ROWS);
  constexpr int STAGE = stage_bytes(STREAM_A);
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes must sit on 1024-byte boundaries.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nkb = p.d / BK;
  const int S = p.stages;
  const uint32_t a_s = base;  // resident A (none when it streams)
  const uint32_t b_s = a_s + (STREAM_A ? 0 : nkb * (ROWS * BK * 2));
  const uint32_t bars = b_s + S * STAGE;  // full[S], empty[S], a_full
  const uint32_t a_full = bars + 16 * S;
  // kTri: the column-statistics buffers, after the barriers' 256 bytes
  // (kTopK: its tile buffers there)
  ColStage* cst =
      reinterpret_cast<ColStage*>(smem_raw + (bars + 256 - smem_u32(smem_raw)));
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int n_sub = p.n / BN;
  // the walked sub-blocks: all, or kTopK's split blockIdx.y
  const int sb_lo = is_topk(MODE) ? split_sb(p, blockIdx.y) : 0;
  const int sb_hi = is_topk(MODE) ? split_sb(p, blockIdx.y + 1) : n_sub;

  if (MODE == kTri) {
    for (int i = tid; i < col_bytes(p.col_bufs) / 4; i += NTR)
      reinterpret_cast<uint32_t*>(cst)[i] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);            // producer's expect_tx
      mbar_init(bars + 8 * (S + s), 4 * CWG * CL);  // one per consumer warp
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL == 2)
    cluster_sync();  // the peer's barriers exist before its first multicast
  else
    __syncthreads();

  // The role, broadcast from lane 0 so that the compiler sees it is
  // warp-uniform (wgmma in a possibly divergent path is serialized).
  const int role = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (role == CWG) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    if (CWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CWG * 128) {
      if (!STREAM_A) {
        mbar_expect_tx(a_full, nkb * (ROWS * BK * 2));
        for (int kb = 0; kb < nkb; ++kb)
          tma_load(a_s + kb * (ROWS * BK * 2), &tm_a, kb * BK, row0, a_full);
      }
      // Streamed A: per sub-block pair and k block, A's box (none in a
      // block with no rows), then B's boxes of sb and sb + 1: this block's
      // cluster rank loads sub-block sb + rank's box into both blocks.
      const uint32_t rank = STREAM_A ? cluster_rank() : 0;
      const bool a_box = STREAM_A && row0 < p.m;
      int st = 0;
      uint32_t ph = 0;
      for (int sb = sb_lo; sb < sb_hi; sb += STREAM_A ? 2 : 1) {
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(bars + 8 * (S + st), ph ^ 1);
          mbar_expect_tx(bars + 8 * st, STREAM_A && !a_box ? STAGE - BOX : STAGE);
          const uint32_t dst = b_s + st * STAGE;
          if (a_box) tma_load(dst, &tm_a, kb * BK, row0, bars + 8 * st);
          if (STREAM_A)
            tma_load_multicast(dst + (1 + rank) * BOX, &tm_b, kb * BK,
                               (sb + rank) * BN, bars + 8 * st, 0x3);
          else
            tma_load(dst, &tm_b, kb * BK, sb * BN, bars + 8 * st);
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
    // this warpgroup's 64 rows: in resident A, or their offset in a stage
    const uint32_t a_wg = (STREAM_A ? 0 : a_s) + wg * 64 * 128;
    float acc0[64], acc1[64];
    if (!STREAM_A) mbar_wait(a_full, 0);

    // (if constexpr: the resident build compiles without the streamed branch)
    if constexpr (STREAM_A) {
      // per pair of sub-blocks (n_sub is even: n is a multiple of tile, a
      // tile of 256): its k blocks into (acc0 | acc1), then both
      // epilogues in column order.  A block with no rows (the grid is
      // whole clusters) walks the ring all the same.
      const bool has_rows = row0 < p.m;
      for (int sb = sb_lo; sb < sb_hi; sb += 2) {
        for (int kb = 0; kb < nkb; ++kb) mma_pair(acc0, acc1, ring, a_wg, kb, lane);
        wgmma_wait<0>();
        release(ring, ring.prev, lane);
        ring.prev = -1;
        fence_regs(acc0);
        fence_regs(acc1);
        if (has_rows) {
          epilogue<MODE, TIE>(r, acc0, p, sb, row_lo, rloc, lane, cst);
          epilogue<MODE, TIE>(r, acc1, p, sb + 1, row_lo, rloc, lane, cst);
        }
      }
    } else {
      // sub-block 0 into acc0; then per pair of sub-blocks: issue the next
      // sub-block's first stage, finish and consume the current one, issue
      // the rest (n_sub is even: n is a multiple of tile, tile of 256).
      for (int kb = 0; kb < nkb; ++kb) mma_stage<ROWS>(acc0, ring, a_wg, kb, lane);
      for (int sb = sb_lo;; sb += 2) {
        mma_stage<ROWS>(acc1, ring, a_wg, 0, lane);  // sub-block sb is complete
        fence_regs(acc0);
        epilogue<MODE, TIE>(r, acc0, p, sb, row_lo, rloc, lane, cst);
        for (int kb = 1; kb < nkb; ++kb) mma_stage<ROWS>(acc1, ring, a_wg, kb, lane);
        if (sb + 2 == sb_hi) break;
        mma_stage<ROWS>(acc0, ring, a_wg, 0, lane);  // sub-block sb + 1 is complete
        fence_regs(acc1);
        epilogue<MODE, TIE>(r, acc1, p, sb + 1, row_lo, rloc, lane, cst);
        for (int kb = 1; kb < nkb; ++kb) mma_stage<ROWS>(acc0, ring, a_wg, kb, lane);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(ring.empty(ring.prev));
      fence_regs(acc1);
      epilogue<MODE, TIE>(r, acc1, p, sb_hi - 1, row_lo, rloc, lane, cst);
    }

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
    if constexpr (is_topk(MODE)) {  // the merge writes the outputs
      topk_split_out(r, p, row_lo, lane);
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
  if constexpr (CL == 2) cluster_sync();  // the peer's last remote arrives are in
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

// The ring and shared memory of a launch at width d: stages, kTri's
// column buffers, dynamic shared bytes.  A ring needs 2 stages (a consumer
// waits for the next stage before it releases the last); a width whose
// resident A leaves fewer gets stages < 2.
struct Plan {
  int stages, col_bufs;
  size_t smem;
};
template <int MODE, int ROWS, bool STREAM_A>
inline Plan plan(int d) {
  constexpr int STAGE = stage_bytes(STREAM_A);
  const int nkb = d / BK;
  const int a_bytes = STREAM_A ? 0 : nkb * ROWS * BK * 2;
  // alignment, barriers, kTopK's tile buffers
  const int room = SMEM_LIMIT - 1024 - 256 - a_bytes - topk_bytes(MODE);
  Plan q{room / STAGE < MAX_STAGES ? room / STAGE : MAX_STAGES, 0, 0};
  if (MODE == kTri) {
    // as deep a ring as fits beside enough column buffers (see epilogue):
    // resident col_bufs * nkb > stages, streamed (col_bufs / 2) * nkb > stages
    for (; q.stages >= 2; --q.stages) {
      q.col_bufs = STREAM_A ? 2 * (q.stages / nkb + 1) : q.stages / nkb + 1;
      if (q.stages * STAGE + col_bytes(q.col_bufs) <= room) break;
    }
  }
  q.smem = 1024 + a_bytes + static_cast<size_t>(q.stages) * STAGE + 256 +
           col_bytes(q.col_bufs) + topk_bytes(MODE);
  return q;
}

// The launch of scan_kernel<MODE, ROWS, TIE, STREAM_A> at p.d and p.m: its
// plan into q, the kernel's dynamic shared memory set, and cfg over one
// block per ROWS rows on `stream`, rounded up to whole clusters (the
// cluster dimension in attr).  Returns a cudaError_t; a width whose ring
// would have fewer than 2 stages is refused.
template <int MODE, int ROWS, int TIE, bool STREAM_A>
inline int configure(const Args& p, void* stream, Plan& q, cudaLaunchConfig_t& cfg,
                     cudaLaunchAttribute& attr) {
  constexpr int CL = cluster_of(STREAM_A);
  q = plan<MODE, ROWS, STREAM_A>(p.d);
  if (q.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scan_kernel<MODE, ROWS, TIE, STREAM_A>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(q.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned rows_blocks = static_cast<unsigned>((p.m + ROWS - 1) / ROWS);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((rows_blocks + CL - 1) / CL * CL);
  cfg.blockDim = dim3(threads(ROWS));
  cfg.dynamicSmemBytes = q.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

// Launch scan_kernel<MODE, ROWS, TIE, STREAM_A> on p (see configure);
// returns the cudaError_t (or kEncodeError + CUresult when a TMA
// descriptor cannot be built).
template <int MODE, int ROWS = BM, int TIE = kFirst, bool STREAM_A = false>
inline int launch(Args p, void* stream) {
  Plan q;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int c = configure<MODE, ROWS, TIE, STREAM_A>(p, stream, q, cfg, attr);
  if (c != 0) return c;
  p.stages = q.stages;
  p.col_bufs = q.col_bufs;
  CUtensorMap tm_a, tm_b;
  int e = make_map(&tm_a, p.A, p.m, p.d, ROWS);
  if (e == 0) e = make_map(&tm_b, p.B, p.n, p.d);
  if (e != 0) return e;
  auto kernel = scan_kernel<MODE, ROWS, TIE, STREAM_A>;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_b, p);
  const cudaError_t last = cudaGetLastError();  // clears what the launch set
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

// Tests only: stream A at every width (set through p1h_force_stream_a).
inline bool force_stream_a = false;

// Whether the scan streams A at width d: past RESIDENT_MAX_D, or whenever
// force_stream_a is set (the check that the two give the same bits).
inline bool streams_a(int d) { return force_stream_a || d > RESIDENT_MAX_D; }

// kClosed, kChain and kTri at any width: A resident or streamed (streams_a).
template <int MODE>
inline int launch_scan(const Args& p, void* stream) {
  return streams_a(p.d) ? launch<MODE, BM, kFirst, true>(p, stream)
                        : launch<MODE>(p, stream);
}

// The plan of the launch launch_scan<MODE> makes at width d, launching
// nothing: [dynamic shared bytes, ring stages, kTri's column buffers,
// blocks of a cluster, cudaOccupancyMaxActiveClusters] into out.  Returns
// a cudaError_t.
template <int MODE, bool STREAM_A>
inline int plan_of(int d, int* out) {
  Args p{};
  p.m = 1;
  p.d = d;
  Plan q;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int c = configure<MODE, BM, kFirst, STREAM_A>(p, nullptr, q, cfg, attr);
  if (c != 0) return c;
  out[0] = static_cast<int>(q.smem);
  out[1] = q.stages;
  out[2] = q.col_bufs;
  out[3] = cluster_of(STREAM_A);
  auto kernel = scan_kernel<MODE, BM, kFirst, STREAM_A>;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(&out[4], kernel, &cfg));
}
template <int MODE>
inline int plan_info(int d, int* out) {
  return streams_a(d) ? plan_of<MODE, true>(d, out) : plan_of<MODE, false>(d, out);
}

}  // namespace p1h

// The test switch of every library built on this scan: nonzero streams A
// through the ring where it would fit resident too.
extern "C" void p1h_force_stream_a(int on) { p1h::force_stream_a = on != 0; }

// A library's p1h_plan(d, out): p1h::plan_info of the scan it launches.
#define P1H_EXPORT_PLAN(MODE)                                              \
  extern "C" int p1h_plan(int64_t d, void* out) {                          \
    return p1h::plan_info<MODE>(static_cast<int>(d), static_cast<int*>(out)); \
  }
