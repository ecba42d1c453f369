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
// 3.35 TB/s.
//
// Design: one warp per row, the row's dim-float histogram in shared memory.
// Lane j computes window p0 + j's (bucket, value); the warp then walks the
// 32 windows in order, broadcasting each, and only the lane that owns the
// bucket (b % 32 == lane) adds it.  No float atomics: every bucket sums its
// windows in window order, so repeated runs are bitwise identical (and equal
// to a sequential index_add_ in window order).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int code_at(const void* codes, int packed,
                                       int64_t row_off, int i) {
  if (packed) {
    const uint32_t w =
        reinterpret_cast<const uint32_t*>(codes)[row_off + i / 5];
    return static_cast<int>((w >> (6 * (i % 5))) & 63u);
  }
  return reinterpret_cast<const uint8_t*>(codes)[row_off + i];
}

__global__ void device_hash_codes_kernel(
    const void* __restrict__ codes, int packed, int64_t stride, int width,
    const float* __restrict__ inv_norm, const int* __restrict__ table,
    const float* __restrict__ idf, int64_t n, int dim, int shift, int base,
    int ngram, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float hist_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= n) return;  // whole warp leaves together; no block barrier below
  float* hist = hist_all + static_cast<int64_t>(warp) * dim;
  for (int b = lane; b < dim; b += 32) hist[b] = 0.f;
  __syncwarp();

  const int64_t row_off = row * stride;
  const int win = width - ngram + 1;  // <= 0: no windows, h stays 0
  for (int p0 = 0; p0 < win; p0 += 32) {
    const int p = p0 + lane;
    int bucket = -1;
    float val = 0.f;
    if (p < win) {
      int key = 0;
      for (int j = 0; j < ngram; ++j)
        key = key * base + code_at(codes, packed, row_off, p + j);
      const int id = table[key];
      if (id >= 0) {
        val = idf[id];
        bucket = static_cast<int>(
            (static_cast<uint32_t>(id) * 2654435761u) >> shift);
      }
    }
    unsigned pending = __ballot_sync(0xffffffffu, bucket >= 0);
    while (pending) {  // windows in order: lowest lane first
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const int b = __shfl_sync(0xffffffffu, bucket, src);
      const float v = __shfl_sync(0xffffffffu, val, src);
      if ((b & 31) == lane) hist[b] += v;
    }
  }
  __syncwarp();
  const float inv = inv_norm[row];
  __nv_bfloat16* o = out + row * dim;
  for (int b = lane; b < dim; b += 32) o[b] = __float2bfloat16_rn(hist[b] * inv);
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
  // Warps (rows) per block: as many as fit 64 KB of histograms, 1..8.
  int wpb = static_cast<int>(65536 / (dim * 4));
  wpb = wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
  const size_t smem = static_cast<size_t>(wpb) * dim * sizeof(float);
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
