// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile geometry, the bf16 tensor-core product,
// tile loads, and the counter-hash dropout of
// w2v2_speaker_tpu/ops/flash_attention.py::_dropout_keep (:83).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLds = kD + 8;  // padded shared-memory row stride (bf16)

__device__ __forceinline__ int clamp_length(const int* lengths, int b, int T) {
  return lengths ? min(max(lengths[b], 0), T) : T;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
// Fragments (g = lane / 4, t4 = lane % 4): a0 = A[g][2t4..], a1 = A[g+8][2t4..],
// a2 = A[g][2t4+8..], a3 = A[g+8][2t4+8..]; b0 = B[2t4..][g], b1 = B[2t4+8..][g];
// c0, c1 = C[g][2t4..], c2, c3 = C[g+8][2t4..].
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows x 64 bf16 from global (row stride `st` elements) into padded
// shared memory; rows >= n_rows are zero-filled. With `scale` != 0 each value
// is multiplied by it and rounded to bf16 again (the prescaled qs). 128
// threads, 16 B each.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long st, int n_rows,
                                               int tid, float scale = 0.f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * 128;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + r * st + col);
      if (scale != 0.f) {
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

// The A fragments of 16 rows (row0 .. row0 + 15) x 64 columns of a padded
// bf16 tile, one per 16-wide step along the 64 columns.
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4],
                                             const __nv_bfloat16* tile,
                                             int row0, int g, int t4) {
  const __nv_bfloat16* base = tile + (row0 + g) * kLds + t4 * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(base + kk * 16);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + kk * 16);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(base + kk * 16 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + kk * 16 + 8);
  }
}

// acc[16 x 64] += A[16 x 64] * B[64 x 64] where A is given as the eight
// 16x8 accumulator fragments x[n] of a product over 64 columns (repacked in
// registers as A operands, rounded to bf16) and B is a padded bf16 tile read
// down its rows: B[k][n] = tile[k][n].
__device__ __forceinline__ void mma_frags_tile(float acc[8][4],
                                               const float x[8][4],
                                               const __nv_bfloat16* tile,
                                               int g, int t4) {
  const uint16_t* raw = reinterpret_cast<const uint16_t*>(tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const uint16_t* br = raw + (kk * 16 + t4 * 2) * kLds + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint16_t* c = br + n * 8;
      mma_bf16(acc[n], a, pack_raw(c[0], c[kLds]),
               pack_raw(c[8 * kLds], c[9 * kLds]));
    }
  }
}

// x[16 x 64] = A[16 x 64] * tile^T, with A given as fragments a (from
// load_a_frags) and tile a padded bf16 64 x 64 tile: x[i][j] = A[i] . tile[j].
__device__ __forceinline__ void mma_frags_tile_t(float x[8][4],
                                                 const uint32_t a[4][4],
                                                 const __nv_bfloat16* tile,
                                                 int g, int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    const __nv_bfloat16* r = tile + (n * 8 + g) * kLds + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_bf16(x[n], a[kk], *reinterpret_cast<const uint32_t*>(r + kk * 16),
               *reinterpret_cast<const uint32_t*>(r + kk * 16 + 8));
  }
}

// Attention-prob dropout: keep where the murmur3 finalizer of
// seed + bh * 0x9E3779B1 + q * 0x85EBCA77 + k * 0xC2B2AE3D (uint32, wrapping)
// is >= thresh = min(rate * 2^32, 2^32 - 1); kept values are scaled by
// inv_keep = 1 / (1 - rate) in f32.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;

  __device__ __forceinline__ bool keep(int bh, int q, int k) const {
    uint32_t x = seed + static_cast<uint32_t>(bh) * 0x9E3779B1u +
                 static_cast<uint32_t>(q) * 0x85EBCA77u +
                 static_cast<uint32_t>(k) * 0xC2B2AE3Du;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x >= thresh;
  }

  __device__ __forceinline__ float apply(float v, int bh, int q, int k) const {
    return keep(bh, q, k) ? v * inv_keep : 0.f;
  }
};

}  // namespace
