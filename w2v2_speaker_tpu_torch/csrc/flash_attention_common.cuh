// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): tile geometry, the bf16 tile copies into
// 128-byte-swizzled shared memory (cp.async) with the qs prescale, the
// wgmma accumulator layout, and the counter-hash dropout of
// w2v2_speaker_tpu/ops/flash_attention.py::_dropout_keep (:83).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kTileBytes = 64 * 128;  // a 64 x 64 bf16 tile of 128-byte rows

__device__ __forceinline__ int clamp_length(const int* lengths, int b, int T) {
  return lengths ? min(max(lengths[b], 0), T) : T;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The smem base of a kernel's dynamic shared memory, rounded up to the
// 1024-byte alignment of the swizzled tiles (the kernels ask for 1 KB of
// slack).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// kRows rows x 64 bf16 (row stride `st` elements) by cp.async into a
// 128-byte-swizzled tile; rows >= n_rows (>= 1) are zero-filled, their
// source address row 0's (legal, not read). kThreads threads: thread tid
// moves the 16-byte chunks tid + kThreads i.
template <int kRows = 64, int kThreads = 128>
__device__ __forceinline__ void cp_async_tile(uint8_t* dst, const __nv_bfloat16* src,
                                              long long st, int n_rows, int tid) {
  constexpr int kChunks = kRows * 8;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    if (kChunks % kThreads == 0 || c < kChunks) {
      const int r = c >> 3, chunk = c & 7;
      const bool ok = r < n_rows;
      cp_async_16(dst + sw128_offset(r, chunk), ok ? src + r * st + chunk * 8 : src, ok);
    }
  }
}

// q * scale rounded to bf16 again (qs = q * bf16(d^-0.5 log2 e)), in place,
// on the chunks thread tid (of 128) copied into a 64-row swizzled tile with
// cp_async_tile; after cp_async_wait, before fence_proxy_async
__device__ __forceinline__ void prescale_tile(uint8_t* tile, int tid, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * 128;
    uint4* chunk = reinterpret_cast<uint4*>(tile + sw128_offset(c >> 3, c & 7));
    uint4 val = *chunk;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *chunk = val;
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0 (the
// scores' exponents are <= 0; a flushed term is below 2^-126 of the row's
// largest)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator element i of a wgmma m64nN product (hopper.cuh) lies in row
// 16 warp + g + 8 acc_half(i) and column acc_col(i, t4) (g = lane / 4, t4 =
// lane % 4): the rows and columns of the m16n8 fragments of mma.sync, so
// the dropout coordinates of every element are those of the first kernels.
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }

__device__ __forceinline__ int acc_col(int i, int t4) {
  return 8 * (i >> 2) + 2 * t4 + (i & 1);
}

// The register A operand of a 16-key step k16 of `O += P V` or `dQ += dZ K`
// from the first product's accumulators x (64 rows x N keys), rounded to
// bf16; all steps are packed before the first product (else ptxas fences
// between the products, C7519)
template <int kN>
__device__ __forceinline__ void pack_a_operands(uint32_t (&a)[kN / 16][4],
                                                const float (&x)[kN / 2]) {
#pragma unroll
  for (int k16 = 0; k16 < kN / 16; ++k16)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[k16][j] = pack_bf16(x[8 * k16 + 2 * j], x[8 * k16 + 2 * j + 1]);
}

// Attention-prob dropout: keep where the murmur3 finalizer of
// seed + bh * 0x9E3779B1 + q * 0x85EBCA77 + k * 0xC2B2AE3D (uint32, wrapping)
// is >= thresh = min(rate * 2^32, 2^32 - 1); kept values are scaled by
// inv_keep = 1 / (1 - rate) in f32. bh is the global (batch, head) row of
// the hash, row(b, h) = (b0 + b) * heads + h0 + h: a launch over a block of
// rows (data parallelism, b0 its first global row) or of heads (tensor
// parallelism, h0 its first head of heads) draws the global mask's entries.
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;
  int b0;
  int h0;
  int heads;

  __device__ __forceinline__ int row(int b, int h) const { return (b0 + b) * heads + h0 + h; }

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
