// Flash-attention backward for Hopper, sm_90a: the dq kernel and the dk/dv
// kernel.
//
// Replaces: w2v2_speaker_tpu/ops/flash_attention.py::_bwd_dq_kernel (:381)
// and ::_bwd_dkv_kernel (:465), launched by _bwd_call (:560).
//
// Function, per (b, h) with len = len[b], qs = q * (d^-0.5 * log2 e) rounded
// to the input type, lse and D = rowsum(dO * O) from the forward, keep() the
// forward's counter-hash dropout mask (flash_attention_common.cuh):
//   P[i, j]  = exp2(qs_i . k_j - lse_i) for i, j < len, else 0
//   dP[i, j] = dO_i . v_j, times keep(i, j) / (1 - rate) (0 where dropped)
//   dZ[i, j] = P[i, j] (dP[i, j] - D_i)
//   dq_i = d^-0.5 sum_j dZ[i, j] k_j               (rows i >= len: 0)
//   dk_j = (sum_i dZ[i, j] qs_i) / log2 e           (rows j >= len: 0)
//   dv_j = sum_i P~[i, j] dO_i, P~ = P keep / (1 - rate)
// dZ and P~ are rounded to the input type before their products, as the
// JAX kernels do (:435, :528-537). Layout: q, k, v, dO [B, T, H, D] with
// D = 64 read through element strides; lse, D f32 [B*H, T]; dq, dk, dv
// contiguous [B, T, H, D].
//
// Bound (H100 SXM: 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor
// cores, 3.35 TB/s): dq 6 and dk/dv 8 x H * D * sum_b len_b^2 FLOPs; bytes
// the valid rows of the inputs read once, the outputs written once. At the
// training shape (B=66, T=149, bf16) both are bound by bytes (~0.02 ms);
// at 30 s and longer by operations.
//
// Design. Two kernels and no atomics, so the gradients are deterministic.
// Both bf16 kernels are Hopper designs on 128-byte-swizzled tiles filled by
// cp.async (16-byte chunks, rows past len zero-filled) and wgmma products
// whose second operand comes from registers (flash_attention_common.cuh,
// hopper.cuh):
// - dq (redesigned for Hopper; the first version, mma.sync after
//   synchronous tile loads with K read by scalar 16-bit shared loads, ran
//   at 4x its bound): one warpgroup per (batch*head, 64-row q tile). The qs
//   and dO tiles land once (qs = q * scale a pass over the landed tile),
//   each thread's two rows of lse and D sit in registers, and the K/V tiles
//   up to len are double-buffered: the next one is copied while this one
//   computes, one barrier per tile, only the boundary tile masked.
//   S = qs K^T and dP = dO V^T are wgmma m64n64k16 with K-major operands;
//   dZ = P (dP keep / (1 - rate) - D), built in the accumulators and
//   rounded to bf16 in registers, is the A operand of dQ += dZ K, whose B
//   is the resident K tile read MN-major. The store is dQ / 8, rows past
//   len 0.
// - dk/dv (redesigned for Hopper; the first version, mma.sync fed by scalar
//   16-bit shared loads after synchronous tile loads, ran at 6x its bound):
//   one warpgroup per (batch*head, 64-key tile), a loop over q tiles that
//   stops at len. K and V, then each q tile's q, dO, lse and D arrive by
//   cp.async; the next q tile is copied into a second stage while the
//   current one computes, and qs = q * scale is a pass over the landed
//   tile. The transposed tiles S^T = K qs^T and dP^T = V dO^T are
//   wgmma m64n64k16 with both operands K-major in shared memory, so the
//   per-q lse and D lie along the accumulators' columns; P~^T and dZ^T,
//   rounded to bf16 in registers, are the register A operands of
//   dV += P~^T dO and dK += dZ^T qs, whose B is the same q tile read
//   MN-major (hopper.cuh). At the training shape it runs at ~3x its bytes
//   bound (PERF.md): with 3 q tiles per (b, h) the prologue weighs as much
//   as the loop, two blocks share an SM (168 registers, 50 KB of shared
//   memory), and each tile's dropout hash and exp2 run between its two
//   pairs of products (their shares are not measured apart).
// - f32 inputs: scalar f32 FMAs (TF32 would miss the f32 tolerance), two
//   threads per row, each holding half of d, the dot products completed
//   with one shuffle.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDqScale = 0.125f;  // d^-0.5 for d = 64, exact in any type

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, T]
  const float* delta;  // [B*H, T]
  void* dq;
  void* dk;
  void* dv;
  const int* lengths;  // [B], or null for all T; clamped to [0, T] here
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  int B, T, H, n_t;
  float scale;  // d^-0.5 * log2(e), already rounded to the input type
  Dropout drop;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, long long sb,
                                       long long sh, int b, int h) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

// ------------------------------------------------------------------- bf16

// qs, dO, two stages of (K, V), 1 KB alignment slack
constexpr int kDqSmem = 6 * kTileBytes + 1024;
// k, v, two stages of (qs, dO), two of (lse, D), 1 KB alignment slack
constexpr int kDkvSmem = 6 * kTileBytes + 4 * kBlockQ * 4 + 1024;

// One warpgroup per (batch*head, 64-row q tile), looping over the K/V
// tiles up to len; the next K/V tile arrives by cp.async in the other stage
// while this one computes. Accumulator element i of every product is (q row
// 16 warp + g + 8 acc_half(i), column acc_col(i, t4)).
template <bool kDrop>
__global__ void __launch_bounds__(128) dq_bf16_kernel(BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs_s = smem;
  uint8_t* do_s = smem + kTileBytes;  // stage s: K at 2 + 2 s, V at 3 + 2 s

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_t;
  const int q0 = (blockIdx.x % p.n_t) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = clamp_length(p.lengths, b, p.T);
  const long long o_st = static_cast<long long>(p.H) * kD;
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) +
                      (static_cast<long long>(b) * p.T + q0) * o_st +
                      static_cast<long long>(h) * kD;

  if (q0 >= len) {  // fully padded q tile: zero gradients, no K/V traffic
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 128;
      const int r = c >> 3;
      if (q0 + r < p.T)
        *reinterpret_cast<uint4*>(dq + r * o_st + (c & 7) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const __nv_bfloat16* kg = at<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, b, h);
  const __nv_bfloat16* vg = at<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, b, h);
  auto load_kv = [&](int k0, int stage) {
    uint8_t* dst = smem + (2 + 2 * stage) * kTileBytes;
    cp_async_tile(dst, kg + k0 * p.k_st, p.k_st, len - k0, tid);
    cp_async_tile(dst + kTileBytes, vg + k0 * p.v_st, p.v_st, len - k0, tid);
  };
  cp_async_tile(qs_s, at<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, b, h) + q0 * p.q_st, p.q_st,
                len - q0, tid);
  cp_async_tile(do_s, at<__nv_bfloat16>(p.dout, p.do_sb, p.do_sh, b, h) + q0 * p.do_st,
                p.do_st, len - q0, tid);
  load_kv(0, 0);
  cp_async_commit();

  // rows 16 warp + g and + 8: validity, lse, D (read while the tiles land)
  int q_abs[2];
  bool rv[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    q_abs[r] = q0 + warp * 16 + g + r * 8;
    rv[r] = q_abs[r] < len;
    const long long i = static_cast<long long>(bh) * p.T + q_abs[r];
    lse[r] = rv[r] ? p.lse[i] : 0.f;
    dlt[r] = rv[r] ? p.delta[i] : 0.f;
  }
  const bool live = q0 + warp * 16 < len;  // this warp has a valid row
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  cp_async_wait<0>();
  prescale_tile(qs_s, tid, p.scale);
  const uint64_t qs_desc = desc_k_major(qs_s), do_desc = desc_k_major(do_s);
  const int n_k = (len + kBlockK - 1) / kBlockK;
  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kBlockK, stage = it & 1;
    cp_async_wait<0>();  // this thread's copies of tile it landed
    fence_proxy_async();
    __syncthreads();  // every copy of tile it landed; every product of tile it - 1 is done
    if (it + 1 < n_k) load_kv(k0 + kBlockK, stage ^ 1);
    cp_async_commit();
    const uint8_t* k_s = smem + (2 + 2 * stage) * kTileBytes;
    const uint8_t* v_s = k_s + kTileBytes;

    // S = qs K^T and dP = dO V^T, both operands K-major (the first step
    // overwrites s and dp)
    float s[32], dp[32];
    const uint64_t k_desc = desc_k_major(k_s), v_desc = desc_k_major(v_s);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      wgmma_ss<64>(s, qs_desc + 2 * k16, k_desc + 2 * k16, k16);
      wgmma_ss<64>(dp, do_desc + 2 * k16, v_desc + 2 * k16, k16);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const bool boundary = k0 + kBlockK > len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // dZ; 0 off the valid (q, k) pairs
      const int r = acc_half(i), key = k0 + acc_col(i, t4);
      const bool valid = live && rv[r] && (!boundary || key < len);
      float dz = 0.f;
      if (valid) {
        const float dpv = kDrop ? p.drop.apply(dp[i], dbh, q_abs[r], key) : dp[i];
        dz = exp2_approx(s[i] - lse[r]) * (dpv - dlt[r]);
      }
      s[i] = dz;
    }

    // dQ += dZ K: dZ from registers, 16 keys a step; K (resident) read MN-major
    uint32_t za[4][4];
    pack_a_operands<64>(za, s);
    const uint64_t k_mn = desc_mn_major(k_s);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) wgmma_rs64_mn(acc, za[k16], k_mn + 128 * k16, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (q0 + row >= p.T) continue;
    __nv_bfloat16* out = dq + row * o_st + t4 * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          rv[r] ? acc[4 * n + 2 * r] * kDqScale : 0.f,
          rv[r] ? acc[4 * n + 2 * r + 1] * kDqScale : 0.f);
  }
}

// One warpgroup per (batch*head, 64-key tile), looping over the q tiles up
// to len; the next q tile's qs, dO, lse and D arrive by cp.async in the
// other stage while this one computes. Accumulator element 4 n + e of every
// product is (key row 16 warp + g + 8 (e / 2), column 8 n + 2 t4 + e % 2).
template <bool kDrop>
__global__ void __launch_bounds__(128) dkv_bf16_kernel(BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + kTileBytes;
  float* lse_s = reinterpret_cast<float*>(smem + 6 * kTileBytes);  // [2][kBlockQ]
  float* dlt_s = lse_s + 2 * kBlockQ;                               // [2][kBlockQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_t;
  const int k0 = (blockIdx.x % p.n_t) * kBlockK;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = clamp_length(p.lengths, b, p.T);
  const long long o_st = static_cast<long long>(p.H) * kD;
  const long long off = (static_cast<long long>(b) * p.T + k0) * o_st +
                        static_cast<long long>(h) * kD;
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(p.dk) + off;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(p.dv) + off;

  if (k0 >= len) {  // key tile past the length: zero gradients
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 128;
      const int r = c >> 3;
      if (k0 + r < p.T) {
        *reinterpret_cast<uint4*>(dk + r * o_st + (c & 7) * 8) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv + r * o_st + (c & 7) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const __nv_bfloat16* qg = at<__nv_bfloat16>(p.q, p.q_sb, p.q_sh, b, h);
  const __nv_bfloat16* dog = at<__nv_bfloat16>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat = static_cast<long long>(bh) * p.T;
  // q tile q0's qs (unscaled yet), dO, lse and D into stage `stage`
  auto load_q_tile = [&](int q0, int stage) {
    cp_async_tile(smem + (2 + stage) * kTileBytes, qg + q0 * p.q_st, p.q_st, len - q0, tid);
    cp_async_tile(smem + (4 + stage) * kTileBytes, dog + q0 * p.do_st, p.do_st, len - q0, tid);
    if (tid < kBlockQ) {
      const bool ok = q0 + tid < len;
      const long long i = stat + (ok ? q0 + tid : 0);
      cp_async_4(lse_s + stage * kBlockQ + tid, p.lse + i, ok);
      cp_async_4(dlt_s + stage * kBlockQ + tid, p.delta + i, ok);
    }
  };
  cp_async_tile(k_s, at<__nv_bfloat16>(p.k, p.k_sb, p.k_sh, b, h) + k0 * p.k_st, p.k_st,
                len - k0, tid);
  cp_async_tile(v_s, at<__nv_bfloat16>(p.v, p.v_sb, p.v_sh, b, h) + k0 * p.v_st, p.v_st,
                len - k0, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  int key[2];
  bool kv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + warp * 16 + g + r * 8;
    kv[r] = key[r] < len;
  }

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;

  const uint64_t k_desc = desc_k_major(k_s), v_desc = desc_k_major(v_s);
  const int n_q = (len + kBlockQ - 1) / kBlockQ;
  for (int it = 0; it < n_q; ++it) {
    const int q0 = it * kBlockQ, stage = it & 1;
    if (it + 1 < n_q) load_q_tile(q0 + kBlockQ, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and k, v) landed; the next may be in flight
    uint8_t* qs_s = smem + (2 + stage) * kTileBytes;
    uint8_t* do_s = smem + (4 + stage) * kTileBytes;
    const float* lse_t = lse_s + stage * kBlockQ;
    const float* dlt_t = dlt_s + stage * kBlockQ;
    prescale_tile(qs_s, tid, p.scale);
    fence_proxy_async();
    __syncthreads();

    // transposed tiles: rows are the keys, columns the 64 queries
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    const uint64_t qs_k = desc_k_major(qs_s), do_k = desc_k_major(do_s);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      wgmma_ss<64>(st, k_desc + 2 * k16, qs_k + 2 * k16, 1);   // K qs^T
      wgmma_ss<64>(dpt, v_desc + 2 * k16, do_k + 2 * k16, 1);  // V dO^T
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qc = n * 8 + t4 * 2 + (e & 1);
        const bool valid = kv[r] && q0 + qc < len;
        const float pv = valid ? exp2f(st[4 * n + e] - lse_t[qc]) : 0.f;
        float ptv = pv, dpv = dpt[4 * n + e];
        if (kDrop) {
          const bool kp = p.drop.keep(dbh, q0 + qc, key[r]);
          ptv = kp ? pv * p.drop.inv_keep : 0.f;
          dpv = kp ? dpv * p.drop.inv_keep : 0.f;
        }
        st[4 * n + e] = ptv;                     // P~^T
        dpt[4 * n + e] = pv * (dpv - dlt_t[qc]);  // dZ^T
      }

    // dV += P~^T dO and dK += dZ^T qs: A from registers (16 queries a step,
    // all packed before the first product), B the same tiles read MN-major
    uint32_t pa[4][4], za[4][4];
    pack_a_operands<64>(pa, st);
    pack_a_operands<64>(za, dpt);
    const uint64_t qs_mn = desc_mn_major(qs_s), do_mn = desc_mn_major(do_s);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      wgmma_rs64_mn(acc_v, pa[k16], do_mn + 128 * k16, 1);
      wgmma_rs64_mn(acc_k, za[k16], qs_mn + 128 * k16, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    __syncthreads();  // every product on this stage is done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (k0 + row >= p.T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const long long c = row * o_st + n * 8 + t4 * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + c) = __floats2bfloat162_rn(
          kv[r] ? acc_k[4 * n + 2 * r] / kLog2e : 0.f,
          kv[r] ? acc_k[4 * n + 2 * r + 1] / kLog2e : 0.f);
      *reinterpret_cast<__nv_bfloat162*>(dv + c) = __floats2bfloat162_rn(
          kv[r] ? acc_v[4 * n + 2 * r] : 0.f, kv[r] ? acc_v[4 * n + 2 * r + 1] : 0.f);
    }
  }
}

// -------------------------------------------------------------------- f32
// 128 threads per 64-row tile: thread pairs share a row, each owning 32 of
// the 64 head dims.

constexpr int kHalf = kD / 2;

// this thread's half of a row of a [B, T, H, D] f32 tensor (0 past n_rows)
__device__ __forceinline__ void load_half_row(float x[kHalf], const float* row,
                                              bool ok, float scale) {
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v = reinterpret_cast<const float4*>(row)[j];
    x[4 * j] = v.x * scale;
    x[4 * j + 1] = v.y * scale;
    x[4 * j + 2] = v.z * scale;
    x[4 * j + 3] = v.w * scale;
  }
}

// 64 rows x 64 f32 from global into shared memory (row stride kD), rows >=
// n_rows zero-filled, each value times `scale`
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long st, int n_rows, int tid,
                                              float scale) {
  for (int c = tid; c < 64 * kD / 4; c += 128) {
    const int r = c / (kD / 4), j = c % (kD / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) v = reinterpret_cast<const float4*>(src + r * st)[j];
    reinterpret_cast<float4*>(dst)[c] =
        make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
  }
}

__device__ __forceinline__ float half_dot(const float x[kHalf], const float* y) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) acc = fmaf(x[d], y[d], acc);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

__device__ __forceinline__ void store_half_row(float* row, const float x[kHalf],
                                               float scale) {
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j)
    reinterpret_cast<float4*>(row)[j] =
        make_float4(x[4 * j] * scale, x[4 * j + 1] * scale,
                    x[4 * j + 2] * scale, x[4 * j + 3] * scale);
}

template <bool kDrop>
__global__ void __launch_bounds__(128) dq_f32_kernel(BwdParams p) {
  __shared__ __align__(16) float k_s[kBlockK * kD];
  __shared__ __align__(16) float v_s[kBlockK * kD];

  const int tid = threadIdx.x;
  const int half = (tid & 1) * kHalf;
  const int bh = blockIdx.x / p.n_t;
  const int q0 = (blockIdx.x % p.n_t) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = clamp_length(p.lengths, b, p.T);
  const int row = q0 + (tid >> 1);
  const bool rv = row < len;
  float* out = static_cast<float*>(p.dq) +
               (static_cast<long long>(b) * p.T + row) * p.H * kD +
               static_cast<long long>(h) * kD + half;
  float acc[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) acc[d] = 0.f;
  if (q0 >= len) {
    if (row < p.T) store_half_row(out, acc, 0.f);
    return;
  }

  float qr[kHalf], dr[kHalf];
  load_half_row(qr, at<float>(p.q, p.q_sb, p.q_sh, b, h) + row * p.q_st + half,
                rv, p.scale);
  load_half_row(dr, at<float>(p.dout, p.do_sb, p.do_sh, b, h) + row * p.do_st + half,
                rv, 1.f);
  const long long stat = static_cast<long long>(bh) * p.T + row;
  const float lse = rv ? p.lse[stat] : 0.f;
  const float dlt = rv ? p.delta[stat] : 0.f;

  const float* kg = at<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* vg = at<float>(p.v, p.v_sb, p.v_sh, b, h);
  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    const int n_valid = min(kBlockK, len - k0);
    __syncthreads();
    load_tile_f32(k_s, kg + k0 * p.k_st, p.k_st, n_valid, tid, 1.f);
    load_tile_f32(v_s, vg + k0 * p.v_st, p.v_st, n_valid, tid, 1.f);
    __syncthreads();
    for (int j = 0; j < n_valid; ++j) {
      const float* kr = k_s + j * kD + half;
      const float s = half_dot(qr, kr);
      float dp = half_dot(dr, v_s + j * kD + half);
      if (kDrop) dp = p.drop.apply(dp, dbh, row, k0 + j);
      const float dz = rv ? exp2f(s - lse) * (dp - dlt) : 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; ++d) acc[d] = fmaf(dz, kr[d], acc[d]);
    }
  }
  if (row < p.T) store_half_row(out, acc, rv ? kDqScale : 0.f);
}

template <bool kDrop>
__global__ void __launch_bounds__(128) dkv_f32_kernel(BwdParams p) {
  __shared__ __align__(16) float qs_s[kBlockQ * kD];
  __shared__ __align__(16) float do_s[kBlockQ * kD];
  __shared__ float lse_s[kBlockQ], dlt_s[kBlockQ];

  const int tid = threadIdx.x;
  const int half = (tid & 1) * kHalf;
  const int bh = blockIdx.x / p.n_t;
  const int k0 = (blockIdx.x % p.n_t) * kBlockK;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = clamp_length(p.lengths, b, p.T);
  const int key = k0 + (tid >> 1);
  const bool kv = key < len;
  const long long off = (static_cast<long long>(b) * p.T + key) * p.H * kD +
                        static_cast<long long>(h) * kD + half;
  float* dk = static_cast<float*>(p.dk) + off;
  float* dv = static_cast<float*>(p.dv) + off;
  float acc_k[kHalf], acc_v[kHalf];
#pragma unroll
  for (int d = 0; d < kHalf; ++d) acc_k[d] = acc_v[d] = 0.f;
  if (k0 >= len) {
    if (key < p.T) {
      store_half_row(dk, acc_k, 0.f);
      store_half_row(dv, acc_v, 0.f);
    }
    return;
  }

  float kr[kHalf], vr[kHalf];
  load_half_row(kr, at<float>(p.k, p.k_sb, p.k_sh, b, h) + key * p.k_st + half, kv, 1.f);
  load_half_row(vr, at<float>(p.v, p.v_sb, p.v_sh, b, h) + key * p.v_st + half, kv, 1.f);

  const float* qg = at<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* dog = at<float>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat = static_cast<long long>(bh) * p.T;
  for (int q0 = 0; q0 < len; q0 += kBlockQ) {
    const int n_valid = min(kBlockQ, len - q0);
    __syncthreads();
    load_tile_f32(qs_s, qg + q0 * p.q_st, p.q_st, n_valid, tid, p.scale);
    load_tile_f32(do_s, dog + q0 * p.do_st, p.do_st, n_valid, tid, 1.f);
    if (tid < kBlockQ) {
      const bool ok = tid < n_valid;
      lse_s[tid] = ok ? p.lse[stat + q0 + tid] : 0.f;
      dlt_s[tid] = ok ? p.delta[stat + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < n_valid; ++i) {
      const float* qrow = qs_s + i * kD + half;
      const float* drow = do_s + i * kD + half;
      const float s = half_dot(kr, qrow);
      float dp = half_dot(vr, drow);
      const float pv = kv ? exp2f(s - lse_s[i]) : 0.f;
      float ptv = pv;
      if (kDrop) {
        const bool kp = p.drop.keep(dbh, q0 + i, key);
        ptv = kp ? pv * p.drop.inv_keep : 0.f;
        dp = kp ? dp * p.drop.inv_keep : 0.f;
      }
      const float dz = pv * (dp - dlt_s[i]);
#pragma unroll
      for (int d = 0; d < kHalf; ++d) {
        acc_v[d] = fmaf(ptv, drow[d], acc_v[d]);
        acc_k[d] = fmaf(dz, qrow[d], acc_k[d]);
      }
    }
  }
  if (key < p.T) {
#pragma unroll
    for (int d = 0; d < kHalf; ++d) acc_k[d] /= kLog2e;
    store_half_row(dk, acc_k, kv ? 1.f : 0.f);
    store_half_row(dv, acc_v, kv ? 1.f : 0.f);
  }
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, const int* lengths,
                      const long long* st, int B, int T, int H, float scale,
                      unsigned seed, unsigned thresh, float inv_keep,
                      int drop_b0, int drop_h0, int drop_heads) {
  return BwdParams{q,     k,     v,     dout,  lse,   delta,
                   dq,    dk,    dv,    lengths,
                   st[0], st[1], st[2], st[3], st[4], st[5],
                   st[6], st[7], st[8], st[9], st[10], st[11],
                   B,     T,     H,     (T + kBlockQ - 1) / kBlockQ,
                   scale, Dropout{seed, thresh, inv_keep, drop_b0, drop_h0, drop_heads}};
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides (q, k, v, dout: batch, time,
// head) are in elements. lse and delta are device f32 [B*H, T]. lengths is
// a device int32 [B] (clamped to [0, T] in the kernel) or null (all T).
// dropout != 0 regenerates the forward's mask: keep(seed, bh, q, k) >=
// thresh, kept entries scaled by inv_keep, bh = (drop_b0 + b) * drop_heads +
// drop_h0 + h as in the forward. Each returns cudaGetLastError()
// after the launch (0 = launched).
#define BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *dout,             \
      const float *lse, const float *delta
#define BWD_TAIL                                                              \
  const int *lengths, long long q_sb, long long q_st, long long q_sh,        \
      long long k_sb, long long k_st, long long k_sh, long long v_sb,        \
      long long v_st, long long v_sh, long long do_sb, long long do_st,      \
      long long do_sh, int B, int T, int H, float scale, int dtype,          \
      unsigned seed, unsigned thresh, float inv_keep, int dropout,           \
      int drop_b0, int drop_h0, int drop_heads, void *stream

extern "C" int flash_attention_bwd_dq(BWD_ARGS, void* dq, BWD_TAIL) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const BwdParams p = make_params(q, k, v, dout, lse, delta, dq, nullptr,
                                  nullptr, lengths, st, B, T, H, scale, seed,
                                  thresh, inv_keep, drop_b0, drop_h0, drop_heads);
  const unsigned grid = static_cast<unsigned>(B) * H * p.n_t;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    void (*kernel)(BwdParams) = dropout ? dq_bf16_kernel<true> : dq_bf16_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, 128, kDqSmem, s>>>(p);
  } else {
    if (dropout) dq_f32_kernel<true><<<grid, 128, 0, s>>>(p);
    else dq_f32_kernel<false><<<grid, 128, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv(BWD_ARGS, void* dk, void* dv, BWD_TAIL) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  const BwdParams p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                  lengths, st, B, T, H, scale, seed, thresh,
                                  inv_keep, drop_b0, drop_h0, drop_heads);
  const unsigned grid = static_cast<unsigned>(B) * H * p.n_t;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    void (*kernel)(BwdParams) = dropout ? dkv_bf16_kernel<true> : dkv_bf16_kernel<false>;
    // above the 48 KB default: dynamic shared memory after the attribute
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, 128, kDkvSmem, s>>>(p);
  } else {
    if (dropout) dkv_f32_kernel<true><<<grid, 128, 0, s>>>(p);
    else dkv_f32_kernel<false><<<grid, 128, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
