// The first fused phase-1 scan for Hopper (sm_90a), on nvcuda::wmma.  Only
// p1_tri_fused.cu uses it (kTri: the triangular self-join's scan, the row
// side plus per-column statistics of the future tiles) until the triangle
// moves onto the TMA/wgmma scan of p1_scan_sm90.cuh, which
// p1_fused_closed2.cu and p1_fused_chain.cu already run.  Modes kClosed and
// kChain below are that scan's earlier form, kept with kTri.
//
// For one block of 128 left rows of A (m, d) bf16 against the walked right
// columns B (n, d) bf16 it computes, per row and per logical tile of `tile`
// columns (string_grouper_tpu/ops/pallas_kernels.py, _p1_body :47-114):
//   s = A . B^T (bf16 products, f32 accumulation); qualified = s >= thr;
//   cnt, the sum of the qualified tile-local column indices, the maximum and
//   its first column (argmax), and the maximum with that column masked;
//   running per-row counts, tmax (largest per-tile count), nfin (candidates
//   extracted), the drop bound tb of tiles with more than 2 qualified
//   columns, and the rank insert (_rank_insert2 :362-380) of the tile's <= 2
//   closed-form candidates into a sorted-desc running top-C.
//
// What bounds it on the H100: the tensor cores.  The product is 2*m*n*d
// operations (989 TF/s dense bf16); B is re-read from L2/HBM once per
// 128-row block, against which the operations per byte of B are 2*128 =
// 256 -- close to the card's ~295 ops/byte balance point, so the row block
// is as tall as shared memory allows.
//
// Design (simple and correct first; wgmma/TMA/warp specialisation are for a
// later change):
// * A block owns 128 left rows and walks every right column in order, 128
//   columns (a sub-block) at a time; the Pallas grid's sequential tile axis
//   is this loop.  The block's A rows stay in shared memory for the whole
//   walk; B arrives in 128-deep k-chunks by cp.async, double-buffered.
// * 8 warps compute the 128x128 f32 score sub-block with nvcuda::wmma
//   bf16 m16n16k16 (f32 accumulate); the scores go to shared memory
//   (aliasing the B buffers).
// * Warp w then reduces rows 16w..16w+15 of the sub-block: lanes hold 4
//   columns each, and (count, index sum, max, first argmax, second max)
//   merge across lanes and across sub-blocks with "smaller column wins
//   ties", so the argmax is jnp.argmax's first occurrence.  Sub-blocks with
//   no qualified score in a row cost one warp vote.
// * The logical tile stays `tile` columns: at its last sub-block the warp
//   folds the tile into the row's counters and, when cnt >= 1, rank-inserts
//   the closed-form candidates into the row's running top-C, kept in global
//   memory (v + c, L2-resident).  The insert keeps _rank_insert2's strict
//   comparisons: i0 = #(v > p0), i1 = #(v > p1) + 1.  Tiles with no
//   qualified column skip the insert: inserting -inf only rewrites the
//   column ids of -inf slots, which every consumer masks, so the column id
//   of a -inf slot is unspecified.
// * kTri only: for walked columns from `fut_start` on, the block also
//   reduces each column of the sub-block over its 128 rows (count, row sum,
//   max, first argmax row, second max; two threads per column, 64 rows
//   each) and writes them to global statistics [block][column], which the
//   fold kernel of p1_tri_fused.cu merges exactly into block_m sub-blocks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace p1 {

using namespace nvcuda;

constexpr int BM = 128;        // left rows per block
constexpr int BN = 128;        // right columns per sub-block
constexpr int KC = 128;        // k-chunk of B per pipeline stage
constexpr int NT = 256;        // threads (8 warps)
constexpr int B_LD = KC + 8;   // bf16 row pitch of a B chunk
constexpr int S_LD = BN + 4;   // f32 row pitch of the score sub-block
constexpr float NEG = -__builtin_huge_valf();

enum Mode { kClosed = 0, kChain = 1, kTri = 2 };

struct Args {
  const __nv_bfloat16* A;  // (m, d) left rows
  const __nv_bfloat16* B;  // (n, d) the walked right columns
  float thr;
  int m, n, d, tile, cand_c;
  int col_off;    // global column id of B's first row
  float* v;       // (m, cand_c) running top-C values
  int* c;         // (m, cand_c) running top-C columns
  int* ship;      // kChain: (m, cand_c) output (kClosed masks c in place)
  int* counts;    // kClosed, kChain: (m,) outputs
  int* tmax;
  float* bound;
  int* meta;      // kChain state (m, 3): [counts, tmax, nfin]
  float* tb;      // kChain state (m,): per-tile drop bound
  float* rmeta;   // kTri (m, 8): [cnt, tmax, bound, nfin, 0, 0, 0, 0]
  int fut_start;  // kTri: first walked column of the column side
  int64_t n_fut;  // kTri: columns of the column side (statistics stride)
  int* st_cnt;    // kTri statistics, (m / 128, n_fut) each
  int* st_s1;
  int* st_row;
  float* st_v;
  float* st_v2;
};

struct RowState {
  int t_cnt[BM];
  int t_s1[BM];
  float t_vmax[BM];
  int t_cmax[BM];
  float t_vmax2[BM];
  int counts[BM];
  int tmax[BM];
  int nfin[BM];
  float tb[BM];
};

struct ColStage {  // kTri: the lower half-block's column statistics
  int cnt[BN];
  int s1[BN];
  float v[BN];
  int row[BN];
  float v2[BN];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Insert (p0, q0) and (p1, q1) (p0 >= p1; p1 = -inf when absent) into the
// row's sorted-desc top-C (v, c) -- the warp-wide form of _rank_insert2.
__device__ void rank_insert2(float* v, int* c, int cand_c, float p0, int q0,
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

template <int MODE>
__global__ void __launch_bounds__(NT, 1) scan_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m = p.m, d = p.d, tile = p.tile, cand_c = p.cand_c;
  const float thr = p.thr;
  const int a_ld = d + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* b_base = smem + static_cast<size_t>(BM) * a_ld * 2;
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(b_base);
  float* S = reinterpret_cast<float*>(b_base);  // aliases Bs after the k loop
  RowState* st = reinterpret_cast<RowState*>(b_base + 2 * BN * B_LD * 2);
  ColStage* cst = reinterpret_cast<ColStage*>(st + 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;

  // ---- A rows: loaded once (zero-filled past m) --------------------------
  const int a_vec = d / 8;  // 16-byte vectors per row
  for (int i = tid; i < BM * a_vec; i += NT) {
    const int r = i / a_vec, k = (i % a_vec) * 8;
    __nv_bfloat16* dst = As + r * a_ld + k;
    if (row0 + r < m) {
      cp_async16(dst, p.A + static_cast<int64_t>(row0 + r) * d + k);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();

  // ---- per-row state: fresh, or the previous chunk's (kChain) -------------
  for (int r = tid; r < BM; r += NT) {
    const int gr = row0 + r;
    if (MODE == kChain && gr < m) {
      st->counts[r] = p.meta[3 * static_cast<int64_t>(gr)];
      st->tmax[r] = p.meta[3 * static_cast<int64_t>(gr) + 1];
      st->nfin[r] = p.meta[3 * static_cast<int64_t>(gr) + 2];
      st->tb[r] = p.tb[gr];
    } else {
      st->counts[r] = 0;
      st->tmax[r] = 0;
      st->nfin[r] = 0;
      st->tb[r] = NEG;
    }
    st->t_cnt[r] = 0;
    st->t_s1[r] = 0;
    st->t_vmax[r] = NEG;
    st->t_cmax[r] = 0x7fffffff;
    st->t_vmax2[r] = NEG;
  }
  if (MODE != kChain) {
    for (int i = tid; i < BM * cand_c; i += NT) {
      const int r = i / cand_c;
      if (row0 + r < m) {
        p.v[static_cast<int64_t>(row0) * cand_c + i] = NEG;
        p.c[static_cast<int64_t>(row0) * cand_c + i] = 0;
      }
    }
  }

  const int wr = warp >> 1;  // rows wr*32 .. +32
  const int wc = warp & 1;   // cols wc*64 .. +64
  const int nk = d / KC;
  const int n_sub = p.n / BN;
  const int sub_per_tile = tile / BN;

  auto load_b = [&](int stage, int col0, int kc) {
    __nv_bfloat16* dst = Bs + stage * BN * B_LD;
    for (int i = tid; i < BN * (KC / 8); i += NT) {
      const int r = i / (KC / 8), k = (i % (KC / 8)) * 8;
      cp_async16(dst + r * B_LD + k,
                 p.B + static_cast<int64_t>(col0 + r) * d + kc * KC + k);
    }
  };

  for (int sb = 0; sb < n_sub; ++sb) {
    const int col0 = sb * BN;  // walked column of this sub-block
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    load_b(0, col0, 0);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        load_b((kc + 1) & 1, col0, kc + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* bs = Bs + (kc & 1) * BN * B_LD;
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wr * 32 + i * 16) * a_ld + kc * KC + kk, a_ld);
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(fb, bs + (wc * 64 + j * 16) * B_LD + kk, B_LD);
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
      __syncthreads();
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(S + (wr * 32 + i * 16) * S_LD + wc * 64 + j * 16,
                                acc[i][j], S_LD, wmma::mem_row_major);
    __syncthreads();

    // ---- row side: warp w owns rows 16w .. 16w+15 ----------------------------
    const int tcol0 = col0 % tile;  // tile-local column of this sub-block
    const bool tile_end = (sb + 1) % sub_per_tile == 0;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      if (row0 + r >= m) break;
      const float4 x = *reinterpret_cast<const float4*>(S + r * S_LD + lane * 4);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      int cnt = 0, s1 = 0, cm = 0x7fffffff;
      float vm = NEG, vm2 = NEG;
      for (int e = 0; e < 4; ++e) {
        if (xs[e] >= thr) {
          const int col = tcol0 + lane * 4 + e;
          ++cnt;
          s1 += col;
          merge_top2(vm, cm, vm2, xs[e], col, NEG);
        }
      }
      if (__any_sync(0xffffffffu, cnt > 0)) {
        for (int o = 16; o; o >>= 1) {
          cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          const float ov = __shfl_xor_sync(0xffffffffu, vm, o);
          const int oc = __shfl_xor_sync(0xffffffffu, cm, o);
          const float ov2 = __shfl_xor_sync(0xffffffffu, vm2, o);
          merge_top2(vm, cm, vm2, ov, oc, ov2);
        }
        if (lane == 0) {
          st->t_cnt[r] += cnt;
          st->t_s1[r] += s1;
          float tv = st->t_vmax[r], tv2 = st->t_vmax2[r];
          int tc = st->t_cmax[r];
          merge_top2(tv, tc, tv2, vm, cm, vm2);
          st->t_vmax[r] = tv;
          st->t_cmax[r] = tc;
          st->t_vmax2[r] = tv2;
        }
        __syncwarp();
      }
      if (!tile_end) continue;
      // ---- fold the finished logical tile into the row -------------------
      const int tcnt = st->t_cnt[r];
      if (tcnt > 0) {
        const float p0 = st->t_vmax[r];
        const int c0 = st->t_cmax[r];
        const bool have2 = tcnt == 2;
        const float p1v = have2 ? st->t_vmax2[r] : NEG;
        const int off = p.col_off + col0 - tcol0;  // global column of the tile
        const int q0 = c0 + off;
        const int q1 = (have2 ? st->t_s1[r] - c0 : 0) + off;
        const int64_t g = static_cast<int64_t>(row0 + r) * cand_c;
        rank_insert2(p.v + g, p.c + g, cand_c, p0, q0, p1v, q1, lane);
      }
      if (lane == 0) {
        st->counts[r] += tcnt;
        st->tmax[r] = max(st->tmax[r], tcnt);
        if (tcnt > 2) st->tb[r] = fmaxf(st->tb[r], st->t_vmax2[r]);
        st->nfin[r] += (tcnt >= 1) + (tcnt == 2);
        st->t_cnt[r] = 0;
        st->t_s1[r] = 0;
        st->t_vmax[r] = NEG;
        st->t_cmax[r] = 0x7fffffff;
        st->t_vmax2[r] = NEG;
      }
      __syncwarp();
    }

    // ---- column side (kTri, future columns): statistics per column --------
    if (MODE == kTri && col0 >= p.fut_start) {
      const int cc = tid & (BN - 1);
      const int h = tid >> 7;  // rows h*64 .. +64
      int cnt = 0, s1 = 0, rm = 0x7fffffff;
      float vm = NEG, vm2 = NEG;
      const float* sc = S + h * 64 * S_LD + cc;
      for (int rr = 0; rr < 64; ++rr) {
        const float x = sc[rr * S_LD];
        if (x >= thr) {
          const int r = h * 64 + rr;
          ++cnt;
          s1 += r;
          merge_top2(vm, rm, vm2, x, r, NEG);
        }
      }
      if (h == 1) {
        cst->cnt[cc] = cnt;
        cst->s1[cc] = s1;
        cst->v[cc] = vm;
        cst->row[cc] = rm;
        cst->v2[cc] = vm2;
      }
      __syncthreads();
      if (h == 0) {
        const int oc = cst->cnt[cc];
        if (oc > 0) {
          cnt += oc;
          s1 += cst->s1[cc];
          merge_top2(vm, rm, vm2, cst->v[cc], cst->row[cc], cst->v2[cc]);
        }
        const int64_t idx = static_cast<int64_t>(blockIdx.x) * p.n_fut +
                            (col0 - p.fut_start + cc);
        p.st_cnt[idx] = cnt;
        if (cnt > 0) {
          p.st_s1[idx] = s1;
          p.st_row[idx] = rm;
          p.st_v[idx] = vm;
          p.st_v2[idx] = vm2;
        }
      }
    }
    __syncthreads();  // S (aliasing Bs) and cst are consumed before reuse
  }

  // ---- outputs --------------------------------------------------------------
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int gr = row0 + r;
    if (gr >= m) break;
    const int64_t g = static_cast<int64_t>(gr) * cand_c;
    if (MODE == kClosed) {
      for (int k = lane; k < cand_c; k += 32)
        if (!(p.v[g + k] > NEG)) p.c[g + k] = -1;
    } else if (MODE == kChain) {
      for (int k = lane; k < cand_c; k += 32)
        p.ship[g + k] = p.v[g + k] > NEG ? p.c[g + k] : -1;
    }
    if (lane == 0) {
      if (MODE == kTri) {
        float* rmeta = p.rmeta + static_cast<int64_t>(gr) * 8;
        rmeta[0] = static_cast<float>(st->counts[r]);
        rmeta[1] = static_cast<float>(st->tmax[r]);
        rmeta[2] = st->tb[r];
        rmeta[3] = static_cast<float>(st->nfin[r]);
        for (int k = 4; k < 8; ++k) rmeta[k] = 0.f;
      } else {
        const float trunc = st->nfin[r] > cand_c ? p.v[g + cand_c - 1] : NEG;
        p.counts[gr] = st->counts[r];
        p.tmax[gr] = st->tmax[r];
        p.bound[gr] = fmaxf(st->tb[r], trunc);
      }
      if (MODE == kChain) {
        p.meta[3 * static_cast<int64_t>(gr)] = st->counts[r];
        p.meta[3 * static_cast<int64_t>(gr) + 1] = st->tmax[r];
        p.meta[3 * static_cast<int64_t>(gr) + 2] = st->nfin[r];
        p.tb[gr] = st->tb[r];
      }
    }
  }
}

inline size_t smem_bytes(int64_t d) {
  return static_cast<size_t>(BM) * (d + 8) * 2 +
         static_cast<size_t>(2) * BN * B_LD * 2 + sizeof(RowState) +
         sizeof(ColStage);
}

// Launch one block per 128 rows on `stream`; returns the cudaError_t.
template <int MODE>
inline int launch(const Args& p, void* stream) {
  const size_t smem = smem_bytes(p.d);
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((p.m + BM - 1) / BM);
  scan_kernel<MODE><<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace p1
