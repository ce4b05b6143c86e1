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
// Bound (H100 SXM: 989 TFLOP/s bf16, 495 TF32, 3.35 TB/s): dq 6 and dk/dv 8
// x H * D * sum_b len_b^2 FLOPs, in f32 three TF32 products each (3xTF32,
// below: the least work that keeps f32 accuracy on the tensor cores, so 3 x
// FLOPs / 495 TFLOP/s); bytes the valid rows of the inputs read once, the
// outputs written once. At the training shape (B=66, T=149) both are bound
// by bytes in bf16 (~0.02 ms) and about evenly in f32 (~0.05 ms); at 30 s
// and longer by operations.
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
// - f32 (redesigned for Hopper; the first version, two threads a row
//   walking shared tiles with scalar FMAs, ran at 1.3-1.9x SDPA's f32
//   backward at 3 s and 64 s on an H100 80GB HBM3 at 700 W, PERF.md): the
//   bf16 designs' products and loops, each product in 3xTF32 on wgmma
//   m64n64k8 (each float split once into tf32 hi and lo tiles, lo.hi +
//   hi.lo + hi.hi accumulated in f32). The tensor
//   cores truncate each k8 step's sum, so every product issues its small
//   terms before its hi.hi terms, and the products summed over the loop
//   (dQ, dK, dV) sum each tile apart and add it in registers, rounded to
//   nearest (PERF.md has their distance from a float64 evaluation beside
//   the plain f32 version's). tf32 wgmma reads both shared-memory operands
//   K-major only, so the products that contract over the tile's rows (dQ
//   += dZ K over keys, dV += P~^T dO and dK += dZ^T qs over queries) take B
//   from transposed copies K^T, dO^T, qs^T split from the landed tile,
//   their rows in the order that lets the first product's accumulators,
//   split in registers, be the A operand unshuffled (split_tile_t). A
//   64 x 64 float tile is 16 KB, its hi and lo 32 KB: tiles land raw by
//   cp.async into a landing area (the next tile's while this one computes)
//   and are split into single-buffered hi/lo tiles, 193 KB (dq) and 226 KB
//   (dk/dv) of shared memory, one block of 128 threads an SM. With no
//   second block to fill the gaps, each tile overlaps what it can with its
//   own products: P (exp2 on the special-function unit) and the dropout
//   keep bits while dP is in flight, and the next tile's split into the
//   tiles the running product does not read (dq: K and V under dQ, then
//   K^T; dk/dv: qs and dO under dV, then qs^T and dO^T).

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
// 3xTF32 on the tensor cores: each float a = hi + lo with hi = tf32(a) and
// lo = tf32(a - hi), both exact tf32 values (22 of a's 24 significant bits),
// and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, ~2^-22 of |a b|,
// left out), accumulated in f32.

constexpr int kF32Tile = 64 * kD * 4;   // 16 KB: 64 rows of 64 floats
constexpr int kF32Half = kF32Tile / 2;  // one 128-byte-swizzled tile of 32 floats a row
// qs, dO (hi, lo); the K/V landing tiles; K, V, K^T (hi, lo); 1 KB alignment slack
constexpr int kDqF32Smem = 12 * kF32Tile + 1024;
// K, V (hi, lo); the q/dO landing tiles; qs, dO, qs^T, dO^T (hi, lo); lse and
// D landed and in use; 1 KB alignment slack
constexpr int kDkvF32Smem = 14 * kF32Tile + 4 * kBlockQ * 4 + 1024;

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Byte offset of element (row, col) of a 64 x 64 float tile in the wgmma
// K-major layout: columns 0-31 in the first 8 KB, 32-63 in the second, each
// a stack of 128-byte swizzled rows.
__device__ __forceinline__ uint32_t f32_offset(int row, int col) {
  return (col >> 5) * kF32Half + sw128_offset(row, (col & 31) >> 2) + (col & 3) * 4;
}

// 64 rows x 64 floats (row stride `st` elements) by cp.async into a tile of
// that layout; rows >= n_rows (>= 1) zero-filled. Thread tid moves the
// 16-byte chunks tid + 128 i (row c / 16, floats 4 (c % 16) ...).
__device__ __forceinline__ void cp_async_tile_f32(uint8_t* dst, const float* src, long long st,
                                                  int n_rows, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = tid + i * 128;
    const int r = c >> 4, j = c & 15;
    const bool ok = r < n_rows;
    cp_async_16(dst + (j >> 3) * kF32Half + sw128_offset(r, j & 7), ok ? src + r * st + j * 4 : src, ok);
  }
}

// The unroll of the splits that run while a product is in flight: two
// chunks in registers at a time beside the product's operands (8 spilled
// more and ran slower: PERF.md)
constexpr int kSplitUnderProduct = 2;

// raw * scale split into the hi and lo tiles, at the same places: the
// chunks thread tid copied with cp_async_tile_f32 (so no barrier is needed
// after its own cp_async_wait); kUnroll chunks at a time
template <int kUnroll = 8>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo, float scale,
                                           int tid) {
#pragma unroll 1
  for (int i0 = 0; i0 < 8; i0 += kUnroll)
#pragma unroll
  for (int i = i0; i < i0 + kUnroll; ++i) {
    const int c = tid + i * 128;
    const int j = c & 15;
    const uint32_t at = (j >> 3) * kF32Half + sw128_offset(c >> 4, j & 7);
    float4 x = *reinterpret_cast<const float4*>(raw + at), h, l;
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    h = make_float4(tf32_round(x.x), tf32_round(x.y), tf32_round(x.z), tf32_round(x.w));
    l = make_float4(tf32_round(x.x - h.x), tf32_round(x.y - h.y), tf32_round(x.z - h.z),
                    tf32_round(x.w - h.w));
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// raw * scale transposed and split: row d of hi_t / lo_t holds column d of
// raw, its 64 rows in the order the register A operand of a later product
// takes them. That operand holds a thread's accumulator columns 2 t4 and
// 2 t4 + 1 of each 8-column step as its k = t4 and t4 + 4 (wgmma_rs_tf32),
// so position 8 s + l of a transposed row holds raw row 8 s + 2 (l % 4) +
// l / 4. Item (d, chunk q of 4 positions) reads raw rows 8 (q / 2) + 2 m +
// q % 2, m = 0..3, and stores one 16-byte chunk; a warp takes 32 columns d
// of one chunk q (conflict-free reads along a row, 4-wavefront stores);
// kUnroll items at a time.
template <int kUnroll = 8>
__device__ __forceinline__ void split_tile_t(const uint8_t* raw, uint8_t* hi_t, uint8_t* lo_t,
                                             float scale, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll 1
  for (int i0 = 0; i0 < 8; i0 += kUnroll)
#pragma unroll
  for (int i = i0; i < i0 + kUnroll; ++i) {
    const int item = warp + 4 * i;  // 0..31
    const int d = lane + 32 * (item & 1), q = item >> 1;
    const int r0 = 8 * (q >> 1) + (q & 1);
    float x[4], h[4], l[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = *reinterpret_cast<const float*>(raw + f32_offset(r0 + 2 * m, d)) * scale;
      h[m] = tf32_round(x[m]);
      l[m] = tf32_round(x[m] - h[m]);
    }
    const uint32_t at = (q >> 3) * kF32Half + sw128_offset(d, q & 7);
    *reinterpret_cast<float4*>(hi_t + at) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo_t + at) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// the descriptor of k8 step s (0..7) of a K-major float tile: 32 bytes
// along the row, the second 8 KB from step 4 on (16-byte units)
__device__ __forceinline__ uint64_t k8_step(uint64_t desc, int s) {
  return desc + (s >> 2) * (kF32Half >> 4) + 2 * (s & 3);
}

// The tensor cores add each k8 step's products to the accumulator and
// truncate the sum to float32, an error of up to an ulp of the running sum
// each step. So a 3xTF32 product issues its small terms (lo.hi and hi.lo,
// ~2^-11 of the result) of all 8 steps first, while the sum is small, then
// the 8 hi.hi steps: 8 truncations at the result's size instead of 24.

// d (=, where scale_d = 0) + the small terms of k8 step s, A and B K-major
// tiles (hi and lo descriptors)
__device__ __forceinline__ void small_ss(float (&d)[32], uint64_t a_hi, uint64_t a_lo, uint64_t b_hi,
                                         uint64_t b_lo, int s, int scale_d) {
  wgmma_ss_tf32(d, k8_step(a_lo, s), k8_step(b_hi, s), scale_d);
  wgmma_ss_tf32(d, k8_step(a_hi, s), k8_step(b_lo, s), 1);
}

// d = A B over the 8 k8 steps, A from registers (hi, lo), B a K-major tile
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a_hi)[8][4],
                                           const uint32_t (&a_lo)[8][4], uint64_t b_hi, uint64_t b_lo) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    wgmma_rs_tf32(d, a_lo[s], k8_step(b_hi, s), s);
    wgmma_rs_tf32(d, a_hi[s], k8_step(b_lo, s), 1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) wgmma_rs_tf32(d, a_hi[s], k8_step(b_hi, s), 1);
}

// The register A operands (hi, lo) of the 8 k8 steps of `dQ += dZ K` (or
// `dV += P~^T dO`, `dK += dZ^T qs`) from the first product's accumulators
// x: step s's k = t4 is accumulator column 8 s + 2 t4, k = t4 + 4 column
// 8 s + 2 t4 + 1 (split_tile_t orders B's rows to match); all steps split
// before the first product
__device__ __forceinline__ void split_a_operands(uint32_t (&a_hi)[8][4], uint32_t (&a_lo)[8][4],
                                                 const float (&x)[32]) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = x[4 * s + ((j & 1) << 1) + (j >> 1)];  // j = 0..3: e = 0, 2, 1, 3
      const float h = tf32_round(v);
      a_hi[s][j] = __float_as_uint(h);
      a_lo[s][j] = __float_as_uint(tf32_round(v - h));
    }
}

// 64 rows of 64 floats of a [B, T, H, D] output from row `row0` set to 0
// (rows >= T left alone)
__device__ __forceinline__ void zero_rows_f32(float* out, long long st, int row0, int T, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = tid + i * 128;
    const int r = c >> 4;
    if (row0 + r < T)
      *reinterpret_cast<float4*>(out + r * st + (c & 15) * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One warpgroup per (batch*head, 64-row q tile), looping over the K/V
// tiles up to len. qs and dO land once (beside K/V tile 0) and are split;
// each K/V tile lands raw (the next one by cp.async while this one
// computes), then K, V and K^T are split into their own tiles.
// Accumulator element i of every product is (q row 16 warp + g + 8
// acc_half(i), column acc_col(i, t4)).
template <bool kDrop>
__global__ void __launch_bounds__(128, 1) dq_f32_kernel(BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs_hi = smem;
  uint8_t* qs_lo = smem + kF32Tile;
  uint8_t* do_hi = smem + 2 * kF32Tile;
  uint8_t* do_lo = smem + 3 * kF32Tile;
  uint8_t* land = smem + 4 * kF32Tile;  // K, then V
  uint8_t* k_hi = smem + 6 * kF32Tile;  // then k_lo, v_hi, v_lo, kt_hi, kt_lo (raw q, dO in the prologue)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_t;
  const int q0 = (blockIdx.x % p.n_t) * kBlockQ;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = clamp_length(p.lengths, b, p.T);
  const long long o_st = static_cast<long long>(p.H) * kD;
  float* dq = static_cast<float*>(p.dq) + (static_cast<long long>(b) * p.T + q0) * o_st +
              static_cast<long long>(h) * kD;

  if (q0 >= len) {  // fully padded q tile: zero gradients, no K/V traffic
    zero_rows_f32(dq, o_st, q0, p.T, tid);
    return;
  }

  const float* kg = at<float>(p.k, p.k_sb, p.k_sh, b, h);
  const float* vg = at<float>(p.v, p.v_sb, p.v_sh, b, h);
  auto load_kv = [&](int k0) {
    cp_async_tile_f32(land, kg + k0 * p.k_st, p.k_st, len - k0, tid);
    cp_async_tile_f32(land + kF32Tile, vg + k0 * p.v_st, p.v_st, len - k0, tid);
  };
  // q and dO land raw in the K/V split tiles (free until the loop), K/V
  // tile 0 in the landing tiles, all at once
  cp_async_tile_f32(k_hi, at<float>(p.q, p.q_sb, p.q_sh, b, h) + q0 * p.q_st, p.q_st, len - q0, tid);
  cp_async_tile_f32(k_hi + kF32Tile, at<float>(p.dout, p.do_sb, p.do_sh, b, h) + q0 * p.do_st,
                    p.do_st, len - q0, tid);
  load_kv(0);
  cp_async_commit();

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
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  cp_async_wait<0>();
  // the chunks this thread copied
  split_tile(k_hi, qs_hi, qs_lo, p.scale, tid);  // qs = q * scale in f32
  split_tile(k_hi + kF32Tile, do_hi, do_lo, 1.f, tid);
  __syncthreads();  // K/V tile 0 landed; the raw q and dO read
  split_tile(land, k_hi, k_hi + kF32Tile, 1.f, tid);
  split_tile(land + kF32Tile, k_hi + 2 * kF32Tile, k_hi + 3 * kF32Tile, 1.f, tid);
  split_tile_t(land, k_hi + 4 * kF32Tile, k_hi + 5 * kF32Tile, 1.f, tid);
  fence_proxy_async();
  __syncthreads();  // the split tiles are complete; the landing tiles are free
  const int n_k = (len + kBlockK - 1) / kBlockK;
  if (n_k > 1) load_kv(kBlockK);
  cp_async_commit();

  const uint64_t qh = desc_k_major(qs_hi), ql = desc_k_major(qs_lo);
  const uint64_t dh = desc_k_major(do_hi), dl = desc_k_major(do_lo);
  const uint64_t kh = desc_k_major(k_hi), kl = desc_k_major(k_hi + kF32Tile);
  const uint64_t vh = desc_k_major(k_hi + 2 * kF32Tile), vl = desc_k_major(k_hi + 3 * kF32Tile);
  const uint64_t kth = desc_k_major(k_hi + 4 * kF32Tile), ktl = desc_k_major(k_hi + 5 * kF32Tile);
  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kBlockK;
    const bool more = it + 1 < n_k;
    // S = qs K^T, then dP = dO V^T, both operands K-major, each product's
    // small terms first (the first step overwrites s and dp); P is taken
    // from S while dP is in flight
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) small_ss(s, qh, ql, kh, kl, k8, k8);
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) wgmma_ss_tf32(s, k8_step(qh, k8), k8_step(kh, k8), 1);
    wgmma_commit();
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) small_ss(dp, dh, dl, vh, vl, k8, k8);
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) wgmma_ss_tf32(dp, k8_step(dh, k8), k8_step(vh, k8), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    const bool boundary = k0 + kBlockK > len;
    uint32_t kept = 0;  // bit i: element i's dropout keep
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // P; 0 off the valid (q, k) pairs
      const int r = acc_half(i), key = k0 + acc_col(i, t4);
      const bool valid = rv[r] && (!boundary || key < len);
      s[i] = valid ? exp2_approx(s[i] - lse[r]) : 0.f;
      if (kDrop && p.drop.keep(dbh, q_abs[r], key)) kept |= 1u << i;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // dZ = P (dP keep / (1 - rate) - D)
      const float dpv = !kDrop ? dp[i] : (kept >> i & 1u) ? dp[i] * p.drop.inv_keep : 0.f;
      s[i] *= dpv - dlt[acc_half(i)];
    }

    // dQ += dZ K: dZ from registers, K^T (keys in the operand's order)
    // K-major; the tile's product summed apart and added in registers
    // (rounded to nearest: the sum over len keys takes no truncation).
    // While it runs, the next K/V tile is split into the K and V tiles
    // (read only by S and dP), after it into K^T.
    uint32_t zh[8][4], zl[8][4];
    split_a_operands(zh, zl, s);
    float part[32];
    wgmma_fence();
    product_rs(part, zh, zl, kth, ktl);
    wgmma_commit();
    if (more) {
      cp_async_wait<0>();
      __syncthreads();  // tile it + 1 landed; S and dP of tile it are done
      split_tile<kSplitUnderProduct>(land, k_hi, k_hi + kF32Tile, 1.f, tid);
      split_tile<kSplitUnderProduct>(land + kF32Tile, k_hi + 2 * kF32Tile, k_hi + 3 * kF32Tile, 1.f, tid);
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    if (more) {
      __syncthreads();  // dQ of tile it is done: K^T is free
      split_tile_t(land, k_hi + 4 * kF32Tile, k_hi + 5 * kF32Tile, 1.f, tid);
      fence_proxy_async();
      __syncthreads();  // the split tiles are complete; the landing tiles are free
      if (it + 2 < n_k) load_kv(k0 + 2 * kBlockK);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (q0 + row >= p.T) continue;
    float* out = dq + row * o_st + t4 * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8) =
          make_float2(rv[r] ? acc[4 * n + 2 * r] * kDqScale : 0.f,
                      rv[r] ? acc[4 * n + 2 * r + 1] * kDqScale : 0.f);
  }
}

// One warpgroup per (batch*head, 64-key tile), looping over the q tiles up
// to len. K and V land once (beside q tile 0) and are split; each q tile's
// q, dO, lse and D land raw (the next tile's by cp.async while this one
// computes), then qs, dO, qs^T and dO^T are split into their own tiles.
// Accumulator element 4 n + e of every product is (key row 16 warp + g +
// 8 (e / 2), column 8 n + 2 t4 + e % 2).
template <bool kDrop>
__global__ void __launch_bounds__(128, 1) dkv_f32_kernel(BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_hi = smem;                 // then k_lo, v_hi, v_lo
  uint8_t* land = smem + 4 * kF32Tile;  // q, then dO
  // then qs_lo, do_hi, do_lo, qst_hi, qst_lo, dot_hi, dot_lo (raw K, V in the prologue)
  uint8_t* qs_hi = smem + 6 * kF32Tile;
  float* lse_land = reinterpret_cast<float*>(smem + 14 * kF32Tile);
  float* dlt_land = lse_land + kBlockQ;
  float* lse_t = lse_land + 2 * kBlockQ;
  float* dlt_t = lse_land + 3 * kBlockQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_t;
  const int k0 = (blockIdx.x % p.n_t) * kBlockK;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = clamp_length(p.lengths, b, p.T);
  const long long o_st = static_cast<long long>(p.H) * kD;
  const long long off = (static_cast<long long>(b) * p.T + k0) * o_st + static_cast<long long>(h) * kD;
  float* dk = static_cast<float*>(p.dk) + off;
  float* dv = static_cast<float*>(p.dv) + off;

  if (k0 >= len) {  // key tile past the length: zero gradients
    zero_rows_f32(dk, o_st, k0, p.T, tid);
    zero_rows_f32(dv, o_st, k0, p.T, tid);
    return;
  }

  const float* qg = at<float>(p.q, p.q_sb, p.q_sh, b, h);
  const float* dog = at<float>(p.dout, p.do_sb, p.do_sh, b, h);
  const long long stat = static_cast<long long>(bh) * p.T;
  auto load_q_tile = [&](int q0) {  // raw q, dO, lse and D of q tile q0
    cp_async_tile_f32(land, qg + q0 * p.q_st, p.q_st, len - q0, tid);
    cp_async_tile_f32(land + kF32Tile, dog + q0 * p.do_st, p.do_st, len - q0, tid);
    if (tid < kBlockQ) {
      const bool ok = q0 + tid < len;
      const long long i = stat + (ok ? q0 + tid : 0);
      cp_async_4(lse_land + tid, p.lse + i, ok);
      cp_async_4(dlt_land + tid, p.delta + i, ok);
    }
  };
  // K and V land raw in the q tile's split tiles (free until the loop), q
  // tile 0 in the landing tiles, all at once
  cp_async_tile_f32(qs_hi, at<float>(p.k, p.k_sb, p.k_sh, b, h) + k0 * p.k_st, p.k_st, len - k0, tid);
  cp_async_tile_f32(qs_hi + kF32Tile, at<float>(p.v, p.v_sb, p.v_sh, b, h) + k0 * p.v_st, p.v_st,
                    len - k0, tid);
  load_q_tile(0);
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

  cp_async_wait<0>();
  // the chunks this thread copied
  split_tile(qs_hi, k_hi, k_hi + kF32Tile, 1.f, tid);
  split_tile(qs_hi + kF32Tile, k_hi + 2 * kF32Tile, k_hi + 3 * kF32Tile, 1.f, tid);
  __syncthreads();  // q tile 0 landed; the raw K and V read
  split_tile(land, qs_hi, qs_hi + kF32Tile, p.scale, tid);  // qs = q * scale in f32
  split_tile(land + kF32Tile, qs_hi + 2 * kF32Tile, qs_hi + 3 * kF32Tile, 1.f, tid);
  split_tile_t(land, qs_hi + 4 * kF32Tile, qs_hi + 5 * kF32Tile, p.scale, tid);
  split_tile_t(land + kF32Tile, qs_hi + 6 * kF32Tile, qs_hi + 7 * kF32Tile, 1.f, tid);
  if (tid < kBlockQ) {
    lse_t[tid] = lse_land[tid];
    dlt_t[tid] = dlt_land[tid];
  }
  fence_proxy_async();
  __syncthreads();  // the split tiles are complete; the landing tiles are free
  const int n_q = (len + kBlockQ - 1) / kBlockQ;
  if (n_q > 1) load_q_tile(kBlockQ);
  cp_async_commit();

  const uint64_t kh = desc_k_major(k_hi), kl = desc_k_major(k_hi + kF32Tile);
  const uint64_t vh = desc_k_major(k_hi + 2 * kF32Tile), vl = desc_k_major(k_hi + 3 * kF32Tile);
  const uint64_t qh = desc_k_major(qs_hi), ql = desc_k_major(qs_hi + kF32Tile);
  const uint64_t dh = desc_k_major(qs_hi + 2 * kF32Tile), dl = desc_k_major(qs_hi + 3 * kF32Tile);
  const uint64_t qth = desc_k_major(qs_hi + 4 * kF32Tile), qtl = desc_k_major(qs_hi + 5 * kF32Tile);
  const uint64_t dth = desc_k_major(qs_hi + 6 * kF32Tile), dtl = desc_k_major(qs_hi + 7 * kF32Tile);
  for (int it = 0; it < n_q; ++it) {
    const int q0 = it * kBlockQ;
    const bool more = it + 1 < n_q;
    // transposed tiles: rows are the keys, columns the 64 queries. S^T =
    // K qs^T, then dP^T = V dO^T, each product's small terms first (the
    // first step overwrites st and dpt); P^T is taken from S^T while dP^T
    // is in flight
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) small_ss(st, kh, kl, qh, ql, k8, k8);
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) wgmma_ss_tf32(st, k8_step(kh, k8), k8_step(qh, k8), 1);
    wgmma_commit();
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) small_ss(dpt, vh, vl, dh, dl, k8, k8);
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) wgmma_ss_tf32(dpt, k8_step(vh, k8), k8_step(dh, k8), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    uint32_t kept = 0;  // bit 4 n + e: element 4 n + e's dropout keep
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qc = n * 8 + t4 * 2 + (e & 1);
        const bool valid = kv[r] && q0 + qc < len;
        st[4 * n + e] = valid ? exp2_approx(st[4 * n + e] - lse_t[qc]) : 0.f;  // P^T
        if (kDrop && p.drop.keep(dbh, q0 + qc, key[r])) kept |= 1u << (4 * n + e);
      }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + t4 * 2 + (e & 1);
        const float pv = st[4 * n + e];
        float ptv = pv, dpv = dpt[4 * n + e];
        if (kDrop) {
          const bool kp = kept >> (4 * n + e) & 1u;
          ptv = kp ? pv * p.drop.inv_keep : 0.f;
          dpv = kp ? dpv * p.drop.inv_keep : 0.f;
        }
        st[4 * n + e] = ptv;                     // P~^T
        dpt[4 * n + e] = pv * (dpv - dlt_t[qc]);  // dZ^T
      }

    // dV += P~^T dO, then dK += dZ^T qs: A from registers, B the transposed
    // tiles dO^T and qs^T (queries in the operand's order) K-major; each
    // tile's product summed apart and added in registers (rounded to
    // nearest), one product at a time (the registers hold one pair of A
    // operands). While dV runs, the next q tile is split into the qs and
    // dO tiles (read only by S^T and dP^T); after dK, into qs^T and dO^T
    // (under dK the registers hold no more).
    uint32_t ah[8][4], al[8][4];
    float part[32];
    split_a_operands(ah, al, st);
    wgmma_fence();
    product_rs(part, ah, al, dth, dtl);
    wgmma_commit();
    if (more) {
      cp_async_wait<0>();
      __syncthreads();  // tile it + 1 landed; S^T and dP^T of tile it are done
      split_tile<kSplitUnderProduct>(land, qs_hi, qs_hi + kF32Tile, p.scale, tid);  // qs = q * scale
      split_tile<kSplitUnderProduct>(land + kF32Tile, qs_hi + 2 * kF32Tile, qs_hi + 3 * kF32Tile, 1.f,
                                     tid);
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_v[i] += part[i];
    split_a_operands(ah, al, dpt);
    wgmma_fence();
    product_rs(part, ah, al, qth, qtl);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[i] += part[i];
    if (more) {
      __syncthreads();  // dK of tile it is done: qs^T, lse and D are free
      split_tile_t(land, qs_hi + 4 * kF32Tile, qs_hi + 5 * kF32Tile, p.scale, tid);
      split_tile_t(land + kF32Tile, qs_hi + 6 * kF32Tile, qs_hi + 7 * kF32Tile, 1.f, tid);
      if (tid < kBlockQ) {
        lse_t[tid] = lse_land[tid];
        dlt_t[tid] = dlt_land[tid];
      }
      fence_proxy_async();
      __syncthreads();  // the split tiles are complete; the landing tiles are free
      if (it + 2 < n_q) load_q_tile(q0 + 2 * kBlockQ);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (k0 + row >= p.T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const long long c = row * o_st + n * 8 + t4 * 2;
      *reinterpret_cast<float2*>(dk + c) = make_float2(kv[r] ? acc_k[4 * n + 2 * r] / kLog2e : 0.f,
                                                       kv[r] ? acc_k[4 * n + 2 * r + 1] / kLog2e : 0.f);
      *reinterpret_cast<float2*>(dv + c) =
          make_float2(kv[r] ? acc_v[4 * n + 2 * r] : 0.f, kv[r] ? acc_v[4 * n + 2 * r + 1] : 0.f);
    }
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
    void (*kernel)(BwdParams) = dropout ? dq_f32_kernel<true> : dq_f32_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqF32Smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, 128, kDqF32Smem, s>>>(p);
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
    void (*kernel)(BwdParams) = dropout ? dkv_f32_kernel<true> : dkv_f32_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvF32Smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, 128, kDkvF32Smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
