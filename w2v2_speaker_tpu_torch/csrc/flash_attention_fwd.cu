// Flash-attention forward (inference) for Hopper, sm_90a.
//
// Replaces: w2v2_speaker_tpu/ops/flash_attention.py::_fwd_kernel (:204),
// launched by _fwd_call (:299), with save_lse=False and dropout rate 0.
//
// Function: o[b, i, h] = sum_j softmax_j(qs[b, i, h] . k[b, j, h]) v[b, j, h]
// over keys j < len[b], in the exp2 domain: qs = q * bf16/f32(d^-0.5 * log2 e)
// is rounded to the input type once, the softmax is taken with exp2. Query
// rows i >= len[b] (and whole rows of a zero-length batch entry) are written
// as exact zeros. Layout [B, T, H, D] with D = 64, read through element
// strides (batch, time, head; the last dim contiguous), so the q/k/v views
// of the fused qkv projection need no repack. o is a contiguous [B, T, H, D].
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

namespace {

constexpr int kD = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kLds = kD + 8;  // padded shared-memory row stride (bf16)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lengths;  // [B], or null for all T; clamped to [0, T] here
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  int B, T, H, n_qt;
  float scale;  // d^-0.5 * log2(e), already rounded to the input type
};

__device__ __forceinline__ int row_length(const Params& p, int b) {
  return p.lengths ? min(max(p.lengths[b], 0), p.T) : p.T;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows x 64 bf16 from global (row stride `st` elements) into padded
// shared memory; rows >= n_rows are zero-filled. 128 threads, 16 B each.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long st, int n_rows,
                                               int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * 128;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) val = *reinterpret_cast<const uint4*>(src + r * st + col);
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

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
    return;
  }

  // Q tile, prescaled and rounded to bf16 (qs = q * scale in the input type)
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                             b * p.q_sb + q0 * p.q_st + h * p.q_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 128;
      const int r = c >> 3;
      const int col = (c & 7) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < p.T) {
        val = *reinterpret_cast<const uint4*>(q + r * p.q_st + col);
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
        }
      }
      *reinterpret_cast<uint4*>(qs_s + r * kLds + col) = val;
    }
  }
  __syncthreads();

  // this warp's 16 rows of qs as mma A fragments, one per 16-wide d step
  uint32_t qa[4][4];
  {
    const __nv_bfloat16* base = qs_s + (warp * 16 + g) * kLds + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + kk * 16);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + kk * 16);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + kk * 16 + 8);
      qa[kk][3] =
          *reinterpret_cast<const uint32_t*>(base + 8 * kLds + kk * 16 + 8);
    }
  }

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
  const uint16_t* v_raw = reinterpret_cast<const uint16_t*>(v_s);

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16(k_s, kg + k0 * p.k_st, p.k_st, len - k0, tid);
    load_tile_bf16(v_s, vg + k0 * p.v_st, p.v_st, len - k0, tid);
    __syncthreads();

    // S = qs K^T for 16 rows x 64 keys: s[n] holds keys n*8 + t4*2 + {0,1}
    // of rows g ({0,1}) and g + 8 ({2,3})
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (n * 8 + g) * kLds + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(s[n], qa[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    }
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
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S fragments of keys kk*16 .. kk*16+15 form the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vr = v_raw + (kk * 16 + t4 * 2) * kLds + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint16_t* c = vr + n * 8;
        mma_bf16(acc[n], pa, pack_raw(c[0], c[kLds]),
                 pack_raw(c[8 * kLds], c[9 * kLds]));
      }
    }
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
    if (row < p.T)
#pragma unroll
      for (int j = 0; j < kD / 4; ++j) orow[j] = make_float4(0.f, 0.f, 0.f, 0.f);
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
#pragma unroll
        for (int d = 0; d < kD / 4; ++d) {
          const float4 vx = vr[d];
          acc[4 * d] = fmaf(s[jj], vx.x, acc[4 * d]);
          acc[4 * d + 1] = fmaf(s[jj], vx.y, acc[4 * d + 1]);
          acc[4 * d + 2] = fmaf(s[jj], vx.z, acc[4 * d + 2]);
          acc[4 * d + 3] = fmaf(s[jj], vx.w, acc[4 * d + 3]);
        }
      }
    }
  }

  if (row >= p.T) return;
  const bool valid = row < len && l_run > 0.f;
#pragma unroll
  for (int j = 0; j < kD / 4; ++j)
    orow[j] = valid ? make_float4(acc[4 * j] / l_run, acc[4 * j + 1] / l_run,
                                  acc[4 * j + 2] / l_run, acc[4 * j + 3] / l_run)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements. lengths is a
// device int32 [B] (each clamped to [0, T] in the kernel) or null (all rows
// have T keys). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const int* lengths, long long q_sb,
                                   long long q_st, long long q_sh,
                                   long long k_sb, long long k_st,
                                   long long k_sh, long long v_sb,
                                   long long v_st, long long v_sh, int B, int T,
                                   int H, float scale, int dtype,
                                   void* stream) {
  Params p{q,    k,    v,    o,    lengths, q_sb, q_st, q_sh, k_sb, k_st,
           k_sh, v_sb, v_st, v_sh, B,       T,    H,    (T + kBlockQ - 1) / kBlockQ,
           scale};
  const unsigned grid = static_cast<unsigned>(B) * H * p.n_qt;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    fwd_bf16_kernel<<<grid, 128, 0, s>>>(p);
  else
    fwd_f32_kernel<<<grid, 64, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
