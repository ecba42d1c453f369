// Hashed TF-IDF projection built on the card from cleaned character codes.
//
// Replaces the XLA program _device_hash_codes of the JAX package
// (string_grouper_tpu/ops/matcher.py:398-464):
//
//     h[i, b] = inv_norm[i] * sum_p idf[t_p] * [bucket(t_p) == b]
//
// over the row's n-gram windows p, t_p = table_id[rolling key of the
// window's codes in base `base`] (-1: out of vocabulary, contributes 0),
// bucket(t) = (t * 2654435761 mod 2^32) >> (33 - bit_length(dim)), output
// bf16 rounded to nearest even.  Codes arrive as raw uint8 rows or 6-bit
// packed, 5 codes per 32-bit word.
//
// What bounds it on the H100: memory.  Each row reads its codes (about one
// byte per character) and writes dim bf16 values; the table and idf lookups
// hit L2.  The bound is the bytes of codes in plus n * dim * 2 bytes out at
// 3.35 TB/s.  The first design (one window at a time per warp, two-byte
// stores) was bound by its instruction count instead.
//
// Design: one warp per row, the row's dim-float histogram in shared memory.
// Windows go in batches of 128 (4 groups of 32, window p0 + 32 g + lane in
// lane `lane`):
// * the lanes load the batch's codes once, coalesced (packed words or
//   bytes), and unpack them into a per-warp byte buffer in shared memory;
// * each lane forms the rolling keys of its 4 windows from that buffer and
//   issues their 4 table loads, then the 4 idf loads, before any add;
// * per group, in order: lanes holding the same bucket find each other with
//   __match_any_sync, and the lowest of them (the earliest window) adds the
//   set's values into the bucket in lane order.  A bucket held by one lane
//   takes one add, so a group usually costs one round.
// No float atomics: every bucket sums its windows in window order, one f32
// add at a time, so repeated runs are bitwise identical and equal to a
// sequential index_add_ in window order.  The histogram leaves scaled by
// inv_norm as bf16, 8 values (16 bytes) per store.
//
// Shared memory per warp: dim floats of histogram, 32 floats of staged
// window values, kCodeBuf bytes of codes; dim up to 32768 (one warp per
// block, 128 KB of histogram).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroups = 4;                // groups of 32 windows per batch
constexpr int kBatch = 32 * kGroups;      // windows per batch
constexpr int kMaxNgram = 32;
// a batch's codes: 128 + ngram - 1, plus up to 4 before p0 (packed words
// start at a multiple of 5) and one word's rounding
constexpr int kCodeBuf = 192;
constexpr int kWarpExtra = 32 * 4 + kCodeBuf;  // bytes per warp beside hist

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(256) device_hash_codes_kernel(
    const void* __restrict__ codes, int packed, int64_t stride, int width,
    const float* __restrict__ inv_norm, const int* __restrict__ table,
    const float* __restrict__ idf, int64_t n, int dim, int shift, int base,
    int ngram, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= n) return;  // whole warp leaves together; no block barrier below
  unsigned char* mine = smem + static_cast<size_t>(warp) * (dim * 4 + kWarpExtra);
  float* hist = reinterpret_cast<float*>(mine);
  float* vals = hist + dim;
  uint8_t* cbuf = reinterpret_cast<uint8_t*>(vals + 32);

  if (dim >= 4) {
    for (int i = lane; i < dim / 4; i += 32)
      reinterpret_cast<float4*>(hist)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int b = lane; b < dim; b += 32) hist[b] = 0.f;
  }

  const int win = width - ngram + 1;  // <= 0: no windows, h stays 0
  for (int p0 = 0; p0 < win; p0 += kBatch) {
    // codes [p0, end) of the row into cbuf, code p0 at cbuf[off]
    const int end = min(p0 + kBatch + ngram - 1, width);
    int off = 0;
    if (packed) {
      const uint32_t* w = static_cast<const uint32_t*>(codes) + row * stride;
      const int w0 = p0 / 5;
      off = p0 - 5 * w0;
      const int nw = (end - 1) / 5 - w0 + 1;
      for (int k = lane; k < nw; k += 32) {
        const uint32_t x = w[w0 + k];
#pragma unroll
        for (int e = 0; e < 5; ++e)
          cbuf[5 * k + e] = static_cast<uint8_t>((x >> (6 * e)) & 63u);
      }
    } else {
      const uint8_t* c = static_cast<const uint8_t*>(codes) + row * stride + p0;
      for (int k = lane; k < end - p0; k += 32) cbuf[k] = c[k];
    }
    __syncwarp();

    // every table load of the batch, then every idf load, then the adds
    int id[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      id[g] = -1;
      if (p0 + 32 * g + lane < win) {
        const uint8_t* cp = cbuf + off + 32 * g + lane;
        int key = 0;
        for (int j = 0; j < ngram; ++j) key = key * base + cp[j];
        id[g] = __ldg(table + key);
      }
    }
    int bucket[kGroups];
    float val[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      bucket[g] = -1;
      val[g] = 0.f;
      if (id[g] >= 0) {
        val[g] = __ldg(idf + id[g]);
        bucket[g] =
            static_cast<int>((static_cast<uint32_t>(id[g]) * 2654435761u) >> shift);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (__ballot_sync(kFull, bucket[g] >= 0) == 0) continue;
      vals[lane] = val[g];
      __syncwarp();
      const unsigned peers = __match_any_sync(kFull, bucket[g]);
      if (bucket[g] >= 0 && (peers & ((1u << lane) - 1u)) == 0) {
        float s = hist[bucket[g]];
        for (unsigned m = peers; m; m &= m - 1) s += vals[__ffs(m) - 1];
        hist[bucket[g]] = s;
      }
      __syncwarp();  // hist and vals before the next group
    }
    __syncwarp();  // cbuf read before the next batch writes it
  }

  const float inv = inv_norm[row];
  __nv_bfloat16* o = out + row * dim;
  if (dim >= 8) {
    for (int i = lane; i < dim / 8; i += 32) {
      const float4 a = reinterpret_cast<const float4*>(hist)[2 * i];
      const float4 b = reinterpret_cast<const float4*>(hist)[2 * i + 1];
      reinterpret_cast<uint4*>(o)[i] = make_uint4(
          bf16x2_bits(a.x * inv, a.y * inv), bf16x2_bits(a.z * inv, a.w * inv),
          bf16x2_bits(b.x * inv, b.y * inv), bf16x2_bits(b.z * inv, b.w * inv));
    }
  } else {
    for (int b = lane; b < dim; b += 32) o[b] = __float2bfloat16_rn(hist[b] * inv);
  }
}

int bit_length(int x) {
  int n = 0;
  while (x) {
    ++n;
    x >>= 1;
  }
  return n;
}

}  // namespace

extern "C" int device_hash_codes(const void* codes, int64_t packed,
                                 int64_t stride, int64_t width,
                                 const void* inv_norm, const void* table,
                                 const void* idf, int64_t n, int64_t dim,
                                 int64_t base, int64_t ngram, void* out,
                                 void* stream) {
  if (ngram < 1 || ngram > kMaxNgram) return static_cast<int>(cudaErrorInvalidValue);
  // Warps (rows) per block: as many as fit 64 KB of histograms, 1..8.
  int wpb = static_cast<int>(65536 / (dim * 4));
  wpb = wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
  const size_t smem = static_cast<size_t>(wpb) * (dim * 4 + kWarpExtra);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        device_hash_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (n + wpb - 1) / wpb;
  const int shift = 32 - bit_length(static_cast<int>(dim)) + 1;
  device_hash_codes_kernel<<<static_cast<unsigned>(blocks), wpb * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      codes, static_cast<int>(packed), stride, static_cast<int>(width),
      static_cast<const float*>(inv_norm), static_cast<const int*>(table),
      static_cast<const float*>(idf), n, static_cast<int>(dim), shift,
      static_cast<int>(base), static_cast<int>(ngram),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
