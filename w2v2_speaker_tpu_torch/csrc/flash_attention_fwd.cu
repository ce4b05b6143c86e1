// Flash-attention forward for Hopper, sm_90a.
//
// Replaces: w2v2_speaker_tpu/ops/flash_attention.py::_fwd_kernel (:204),
// launched by _fwd_call (:299): the inference path (no LSE, rate 0) and the
// training path (save_lse, in-kernel dropout on P).
//
// Function: o[b, i, h] = sum_j softmax_j(qs[b, i, h] . k[b, j, h]) v[b, j, h]
// over keys j < len[b], in the exp2 domain: qs = q * bf16/f32(d^-0.5 * log2 e)
// is rounded to the input type once, the softmax is taken with exp2. Query
// rows i >= len[b] (and whole rows of a zero-length batch entry) are written
// as exact zeros. Layout [B, T, H, D] with D = 64, read through element
// strides (batch, time, head; the last dim contiguous), so the q/k/v views
// of the fused qkv projection need no repack. o is a contiguous [B, T, H, D].
//
// Training outputs and options:
// - lse (optional, f32 [B*H, T]): the log2-domain log-sum-exp m + log2(l) of
//   each valid row, 0 on rows >= len[b] (as _fwd_kernel :289-296 writes 0
//   where l == 0); the backward kernels recompute P = exp2(qs.k - lse);
// - dropout on the post-softmax P: P[i, j] is kept, and scaled by
//   1 / (1 - rate), where keep(seed, b*H + h, i, j) -- the murmur3 finalizer
//   over the absolute coordinates, bit-identical to _dropout_keep (:83) --
//   is >= thresh; the normalizer l sums the undropped P (:249-257). The
//   inference path (no dropout) is a separate instantiation with no hash.
//
// Bound at the main path's shapes (H100 SXM: 989 TFLOP/s bf16 dense,
// 3.35 TB/s HBM). FLOPs = 4 * H * D * sum_b len_b^2; bytes = q, k, v valid
// rows read once + o written once.
//   B=48, T=149 (3 s clips): 3.3 GFLOP, 44 MB  -> memory-bound, ~13 us.
//   B=8,  T=1500 (30 s):     55 GFLOP, 74 MB  -> compute-bound, ~56 us.
//
// Design (first version: right and simple; no TMA, no wgmma yet):
// - one thread block per (batch*head, 64-row q tile); a tile whose first row
//   is >= len writes zeros and returns without touching k or v;
// - a loop over 64-row K/V tiles only up to len: tiles past the length are
//   neither loaded nor computed, and only the boundary tile is masked;
// - K/V tiles staged in shared memory (rows padded by 8 elements so the
//   fragment reads are bank-conflict free), rows >= len zero-filled;
// - bf16: four warps, each owns 16 q rows; S = Qs K^T and O += P V run on the
//   tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate); the S
//   accumulator fragment is re-packed in registers as the A operand of P V
//   (P rounded to bf16, the row sum kept from the f32 P, as _fwd_kernel does);
// - f32: one thread per q row, scalar f32 FMAs (the tensor cores have no
//   full-f32 product; TF32 would miss the f32 tolerance of the reference
//   tests), K/V rows read as shared-memory broadcasts;
// - running max, sum and accumulator in f32 registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // [B*H, T] f32, or null (inference)
  const int* lengths;  // [B], or null for all T; clamped to [0, T] here
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, T, H, n_qt;
  float scale;  // d^-0.5 * log2(e), already rounded to the input type
  Dropout drop;
};

__device__ __forceinline__ int row_length(const Params& p, int b) {
  return clamp_length(p.lengths, b, p.T);
}

template <bool kDrop>
__global__ void __launch_bounds__(128) fwd_bf16_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 qs_s[kBlockQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x % p.n_qt) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const int len = row_length(p, b);
  const long long o_st = static_cast<long long>(p.H) * kD;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                     (static_cast<long long>(b) * p.T + q0) * o_st +
                     static_cast<long long>(h) * kD;

  if (q0 >= len) {  // fully padded q tile: zeros, no K/V traffic
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 128;
      const int r = c >> 3;
      if (q0 + r < p.T)
        *reinterpret_cast<uint4*>(o + r * o_st + (c & 7) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    if (p.lse && tid < kBlockQ && q0 + tid < p.T)
      p.lse[static_cast<long long>(bh) * p.T + q0 + tid] = 0.f;
    return;
  }

  // Q tile, prescaled and rounded to bf16 (qs = q * scale in the input type),
  // and this warp's 16 rows of it as mma A fragments
  load_tile_bf16(qs_s,
                 static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                     q0 * p.q_st + h * p.q_sh,
                 p.q_st, p.T - q0, tid, p.scale);
  __syncthreads();
  uint32_t qa[4][4];
  load_a_frags(qa, qs_s, warp * 16, g, t4);

  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + h * p.v_sh;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16(k_s, kg + k0 * p.k_st, p.k_st, len - k0, tid);
    load_tile_bf16(v_s, vg + k0 * p.v_st, p.v_st, len - k0, tid);
    __syncthreads();

    // S = qs K^T for 16 rows x 64 keys: s[n] holds keys n*8 + t4*2 + {0,1}
    // of rows g ({0,1}) and g + 8 ({2,3})
    float s[8][4];
    mma_frags_tile_t(s, qa, k_s, g, t4);
    if (k0 + kBlockK > len) {  // boundary tile: mask keys >= len
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + n * 8 + t4 * 2 + e >= len) {
            s[n][e] = -INFINITY;
            s[n][e + 2] = -INFINITY;
          }
    }

    // online softmax in exp2; key k0 is valid, so each row max is finite
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mx[0]);
      s[n][1] = exp2f(s[n][1] - mx[0]);
      s[n][2] = exp2f(s[n][2] - mx[1]);
      s[n][3] = exp2f(s[n][3] - mx[1]);
      rs[0] += s[n][0] + s[n][1];
      rs[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
    if (kDrop) {  // drop after the row sum: l keeps the undropped P
      const int q_abs = q0 + warp * 16 + g;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p.drop.apply(s[n][e], bh, q_abs + (e >> 1) * 8,
                                 k0 + n * 8 + t4 * 2 + (e & 1));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S fragments of keys kk*16 .. kk*16+15 form the A operand
    mma_frags_tile(acc, s, v_s, g, t4);
  }

  // finalize: full row sums across the quad, zeros for rows >= len
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (q0 + row >= p.T) continue;
    const bool valid = q0 + row < len && l_run[r] > 0.f;
    if (p.lse && t4 == 0)
      p.lse[static_cast<long long>(bh) * p.T + q0 + row] =
          valid ? m_run[r] + log2f(l_run[r]) : 0.f;
    __nv_bfloat16* orow = o + row * o_st + t4 * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float x0 = valid ? acc[n][2 * r] / l_run[r] : 0.f;
      const float x1 = valid ? acc[n][2 * r + 1] / l_run[r] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(64) fwd_f32_kernel(Params p) {
  __shared__ __align__(16) float k_s[kBlockK * kD];
  __shared__ __align__(16) float v_s[kBlockK * kD];
  constexpr int kChunk = 16;

  const int tid = threadIdx.x;  // this thread's q row within the tile
  const int bh = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x % p.n_qt) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const int len = row_length(p, b);
  const int row = q0 + tid;
  const long long o_st = static_cast<long long>(p.H) * kD;
  float4* orow = reinterpret_cast<float4*>(
      static_cast<float*>(p.o) + (static_cast<long long>(b) * p.T + row) * o_st +
      static_cast<long long>(h) * kD);

  if (q0 >= len) {
    if (row < p.T) {
#pragma unroll
      for (int j = 0; j < kD / 4; ++j) orow[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p.lse) p.lse[static_cast<long long>(bh) * p.T + row] = 0.f;
    }
    return;
  }

  float qr[kD];
  {
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb +
                     static_cast<long long>(row) * p.q_st + h * p.q_sh;
#pragma unroll
    for (int j = 0; j < kD / 4; ++j) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < p.T) x = reinterpret_cast<const float4*>(q)[j];
      qr[4 * j] = x.x * p.scale;
      qr[4 * j + 1] = x.y * p.scale;
      qr[4 * j + 2] = x.z * p.scale;
      qr[4 * j + 3] = x.w * p.scale;
    }
  }
  float acc[kD];
#pragma unroll
  for (int j = 0; j < kD; ++j) acc[j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int n_valid = min(kBlockK, len - k0);
    __syncthreads();
    for (int c = tid; c < kBlockK * kD / 4; c += 64) {
      const int r = c / (kD / 4), j = c % (kD / 4);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (r < n_valid) {
        kv = reinterpret_cast<const float4*>(kg + (k0 + r) * p.k_st)[j];
        vv = reinterpret_cast<const float4*>(vg + (k0 + r) * p.v_st)[j];
      }
      reinterpret_cast<float4*>(k_s)[c] = kv;
      reinterpret_cast<float4*>(v_s)[c] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n_valid; j0 += kChunk) {
      float s[kChunk];
      float mx = m_run;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + (j0 + jj) * kD);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kD / 4; ++d) {
          const float4 kx = kr[d];
          dot = fmaf(qr[4 * d], kx.x, dot);
          dot = fmaf(qr[4 * d + 1], kx.y, dot);
          dot = fmaf(qr[4 * d + 2], kx.z, dot);
          dot = fmaf(qr[4 * d + 3], kx.w, dot);
        }
        s[jj] = j0 + jj < n_valid ? dot : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = exp2f(m_run - mx);
      m_run = mx;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = exp2f(s[jj] - mx);
        rs += s[jj];
      }
      l_run = l_run * alpha + rs;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* vr = reinterpret_cast<const float4*>(v_s + (j0 + jj) * kD);
        const float pv =
            kDrop ? p.drop.apply(s[jj], bh, row, k0 + j0 + jj) : s[jj];
#pragma unroll
        for (int d = 0; d < kD / 4; ++d) {
          const float4 vx = vr[d];
          acc[4 * d] = fmaf(pv, vx.x, acc[4 * d]);
          acc[4 * d + 1] = fmaf(pv, vx.y, acc[4 * d + 1]);
          acc[4 * d + 2] = fmaf(pv, vx.z, acc[4 * d + 2]);
          acc[4 * d + 3] = fmaf(pv, vx.w, acc[4 * d + 3]);
        }
      }
    }
  }

  if (row >= p.T) return;
  const bool valid = row < len && l_run > 0.f;
  if (p.lse)
    p.lse[static_cast<long long>(bh) * p.T + row] =
        valid ? m_run + log2f(l_run) : 0.f;
#pragma unroll
  for (int j = 0; j < kD / 4; ++j)
    orow[j] = valid ? make_float4(acc[4 * j] / l_run, acc[4 * j + 1] / l_run,
                                  acc[4 * j + 2] / l_run, acc[4 * j + 3] / l_run)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements. lse is a device
// f32 [B*H, T] or null (not written). lengths is a device int32 [B] (each
// clamped to [0, T] in the kernel) or null (all rows have T keys). dropout
// != 0 drops P with keep(seed, bh, q, k) >= thresh and scales the kept
// entries by inv_keep = 1 / (1 - rate). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* lengths,
                                   long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb,
                                   long long k_st, long long k_sh,
                                   long long v_sb, long long v_st,
                                   long long v_sh, int B, int T, int H,
                                   float scale, int dtype, unsigned seed,
                                   unsigned thresh, float inv_keep,
                                   int dropout, void* stream) {
  Params p{q,    k,    v,    o,    lse,  lengths, q_sb, q_st,
           q_sh, k_sb, k_st, k_sh, v_sb, v_st,    v_sh, B,
           T,    H,    (T + kBlockQ - 1) / kBlockQ, scale,
           Dropout{seed, thresh, inv_keep}};
  const unsigned grid = static_cast<unsigned>(B) * H * p.n_qt;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dropout)
      fwd_bf16_kernel<true><<<grid, 128, 0, s>>>(p);
    else
      fwd_bf16_kernel<false><<<grid, 128, 0, s>>>(p);
  } else {
    if (dropout)
      fwd_f32_kernel<true><<<grid, 64, 0, s>>>(p);
    else
      fwd_f32_kernel<false><<<grid, 64, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
