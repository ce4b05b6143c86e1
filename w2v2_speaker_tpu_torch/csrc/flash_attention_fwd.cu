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
//   is >= thresh; b and h are global coordinates (Dropout::row), so a
//   launch over a rank's rows or heads draws the global mask's entries; the normalizer l sums the undropped P (:249-257). The
//   inference path (no dropout) is a separate instantiation with no hash.
//
// Bound (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM). FLOPs = 4 * H *
// D * sum_b len_b^2; bytes = q, k, v valid rows read once + o (and the f32
// lse) written once. LARGE training (B=48, T=149, H=16): bytes, ~0.018 ms;
// a 64 s utterance pair (B=2, T=3200, H=12): operations, ~0.058 ms. At D=64
// the exp2 of every score costs as much on the SM's 16 special-function
// lanes as the two products on the tensor cores.
//
// Design, bf16 (redesigned for Hopper; the first version -- mma.sync fed by
// synchronous tile loads and scalar 16-bit shared loads of V -- ran at 4x
// its bound and lost to SDPA at 64 s):
// - a block of kFwdWarpgroups warpgroups (128 threads each) per (batch*head,
//   64 * kFwdWarpgroups q rows); a warpgroup owns 64 q rows, a block whose
//   first row is >= len writes zeros and touches no K or V, a warpgroup
//   whose first row is >= len writes zeros and only helps with the copies;
// - each warpgroup's q tile lands once by cp.async in a 128-byte-swizzled
//   tile, then the prescale pass rounds qs = q * scale to bf16 in place;
// - K/V tiles of kFwdBlockN keys arrive by cp.async (16-byte chunks, rows
//   past len zero-filled) in a ring of kFwdStages stages shared by the
//   warpgroups: tile it + kFwdStages - 1 is in flight while tile it
//   computes, one barrier per tile; tiles past len are neither loaded nor
//   computed, and only the boundary tile is masked;
// - S = qs K^T is wgmma m64nNk16 with both operands K-major in shared
//   memory; the online softmax (running max, f32 row sums of the undropped
//   P, dropout after the sum) runs on the accumulators, whose (row, column)
//   per element are the mma.sync fragments' (acc_half, acc_col);
// - P, rounded to bf16 and packed in registers, is the A operand of
//   O += P V, whose B is the V tile read MN-major (wgmma_rs64_mn);
// - overlap of one tile's softmax with another's products comes from the
//   several blocks an SM holds, not from within a block.
// The kept geometry (warpgroups, keys per tile, stages) is the fastest of
// the variants timed by tools/torch_attention_variants.py (PERF.md).
//
// f32: one thread per q row, scalar f32 FMAs (the tensor cores have no
// full-f32 product; TF32 would miss the f32 tolerance of the reference
// tests), K/V rows read as shared-memory broadcasts; running max, sum and
// accumulator in f32 registers (the first version, unchanged).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kFwdWarpgroups = 1;  // warpgroups a block, 64 q rows each
constexpr int kFwdBlockN = 64;     // keys a K/V tile
constexpr int kFwdStages = 2;      // K/V tiles in the ring
constexpr int kFwdThreads = 128 * kFwdWarpgroups;
constexpr int kFwdRows = 64 * kFwdWarpgroups;  // q rows a block
constexpr int kKvBytes = kFwdBlockN * 128;     // one K or V tile
// the warpgroups' q tiles, the ring of (K, V), 1 KB alignment slack
constexpr int kFwdSmem = kFwdWarpgroups * kTileBytes + kFwdStages * 2 * kKvBytes + 1024;

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
  int B, T, H, n_qt;   // n_qt: q tiles (blocks) per batch*head
  float scale;  // d^-0.5 * log2(e), already rounded to the input type
  Dropout drop;
};

__device__ __forceinline__ int row_length(const Params& p, int b) {
  return clamp_length(p.lengths, b, p.T);
}

// zeros in the 64 o rows (and lse entries) from q0 on, below T; 128 threads
__device__ __forceinline__ void write_zero_rows(__nv_bfloat16* o, long long o_st, float* lse,
                                                int q0, int T, int wtid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = wtid + i * 128;
    const int r = c >> 3;
    if (q0 + r < T)
      *reinterpret_cast<uint4*>(o + r * o_st + (c & 7) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (lse && wtid < 64 && q0 + wtid < T) lse[q0 + wtid] = 0.f;
}

template <bool kDrop>
__global__ void __launch_bounds__(kFwdThreads) fwd_bf16_kernel(Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* kv_s = smem + kFwdWarpgroups * kTileBytes;  // stage s: K at 2 s, V at 2 s + 1

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / p.n_qt;
  const int b = bh / p.H, h = bh % p.H;
  const int dbh = p.drop.row(b, h);  // the hash's global row
  const int len = row_length(p, b);
  const int block_q0 = (blockIdx.x % p.n_qt) * kFwdRows;
  const int q0 = block_q0 + wg * 64;  // this warpgroup's first row
  const long long o_st = static_cast<long long>(p.H) * kD;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                     (static_cast<long long>(b) * p.T + q0) * o_st +
                     static_cast<long long>(h) * kD;
  float* lse = p.lse ? p.lse + static_cast<long long>(bh) * p.T : nullptr;

  if (block_q0 >= len) {  // fully padded block: zeros, no K/V traffic
    write_zero_rows(o, o_st, lse, q0, p.T, wtid);
    return;
  }
  const bool active = q0 < len;  // else this warpgroup's rows are padding

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kFwdBlockN;
    uint8_t* dst = kv_s + stage * 2 * kKvBytes;
    cp_async_tile<kFwdBlockN, kFwdThreads>(dst, kg + k0 * p.k_st, p.k_st, len - k0, tid);
    cp_async_tile<kFwdBlockN, kFwdThreads>(dst + kKvBytes, vg + k0 * p.v_st, p.v_st, len - k0, tid);
  };
  uint8_t* qs_s = smem + wg * kTileBytes;
  if (active)
    cp_async_tile(qs_s,
                  static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + q0 * p.q_st + h * p.q_sh,
                  p.q_st, len - q0, wtid);
  const int n_k = (len + kFwdBlockN - 1) / kFwdBlockN;
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {  // q rides in the first group
    if (s < n_k) load_kv(s, s);
    cp_async_commit();
  }
  cp_async_wait<kFwdStages - 2>();  // q (and K/V tile 0) landed
  if (active) prescale_tile(qs_s, wtid, p.scale);

  const int q_row = q0 + warp * 16 + g;  // this thread's rows: q_row, q_row + 8
  const bool live = q0 + warp * 16 < len;  // this warp has a valid row
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t q_desc = desc_k_major(qs_s);

  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * kFwdBlockN;
    cp_async_wait<kFwdStages - 2>();  // this thread's copies of tile it landed
    fence_proxy_async();
    __syncthreads();  // every copy of tile it landed; every product of tile it - 1 is done
    if (it + kFwdStages - 1 < n_k) load_kv(it + kFwdStages - 1, (it + kFwdStages - 1) % kFwdStages);
    cp_async_commit();
    if (!active) continue;
    const uint8_t* k_s = kv_s + (it % kFwdStages) * 2 * kKvBytes;
    const uint8_t* v_s = k_s + kKvBytes;

    // S = qs K^T: 64 rows x kFwdBlockN keys (the first step overwrites s)
    float s[kFwdBlockN / 2];
    const uint64_t k_desc = desc_k_major(k_s);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) wgmma_ss<kFwdBlockN>(s, q_desc + 2 * k16, k_desc + 2 * k16, k16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (live) {
      if (k0 + kFwdBlockN > len) {  // boundary tile: mask keys >= len
#pragma unroll
        for (int i = 0; i < kFwdBlockN / 2; ++i)
          if (k0 + acc_col(i, t4) >= len) s[i] = -INFINITY;
      }
      // online softmax in exp2; key k0 is valid, so each row max is finite
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kFwdBlockN / 2; ++i) mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m_run[r] - mx[r]);
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kFwdBlockN / 2; ++i) s[i] = exp2_approx(s[i] - mx[acc_half(i)]);
#pragma unroll
      for (int i = 0; i < kFwdBlockN / 2; ++i) rs[acc_half(i)] += s[i];  // l sums the undropped P
      if (kDrop) {  // hashes only for 8-key groups below len (P is 0 past it)
#pragma unroll
        for (int n = 0; n < kFwdBlockN / 8; ++n)
          if (k0 + 8 * n < len) {
#pragma unroll
            for (int i = 4 * n; i < 4 * n + 4; ++i)
              s[i] = p.drop.apply(s[i], dbh, q_row + 8 * acc_half(i), k0 + acc_col(i, t4));
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
      // rescale O to the new max where it moved (a factor of 1 changes no bit)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha[acc_half(i)];
      }
    } else {  // a warp of padded rows: P = 0, its outputs are zeros
#pragma unroll
      for (int i = 0; i < kFwdBlockN / 2; ++i) s[i] = 0.f;
    }

    // O += P V: P from registers, 16 keys a step; V read MN-major
    uint32_t pa[kFwdBlockN / 16][4];
    pack_a_operands<kFwdBlockN>(pa, s);
    const uint64_t v_desc = desc_mn_major(v_s);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kFwdBlockN / 16; ++k16) wgmma_rs64_mn(acc, pa[k16], v_desc + 128 * k16, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if (!active) {
    write_zero_rows(o, o_st, lse, q0, p.T, wtid);
    return;
  }
  // finalize: full row sums across the quad, zeros for rows >= len
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_row + 8 * r;
    if (row >= p.T) continue;
    const bool valid = row < len && l_run[r] > 0.f;
    if (lse && t4 == 0) lse[row] = valid ? m_run[r] + log2f(l_run[r]) : 0.f;
    __nv_bfloat16* orow = o + (row - q0) * o_st + t4 * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float x0 = valid ? acc[4 * n + 2 * r] / l_run[r] : 0.f;
      const float x1 = valid ? acc[4 * n + 2 * r + 1] / l_run[r] : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(x0, x1);
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
  const int dbh = p.drop.row(b, h);  // the hash's global row
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
            kDrop ? p.drop.apply(s[jj], dbh, row, k0 + j0 + jj) : s[jj];
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
// entries by inv_keep = 1 / (1 - rate), bh = (drop_b0 + b) * drop_heads +
// drop_h0 + h (0, 0 and H for a launch over the whole batch and all heads).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* lengths,
                                   long long q_sb, long long q_st,
                                   long long q_sh, long long k_sb,
                                   long long k_st, long long k_sh,
                                   long long v_sb, long long v_st,
                                   long long v_sh, int B, int T, int H,
                                   float scale, int dtype, unsigned seed,
                                   unsigned thresh, float inv_keep,
                                   int dropout, int drop_b0, int drop_h0,
                                   int drop_heads, void* stream) {
  const int rows = dtype == 0 ? kFwdRows : kBlockQ;  // q rows a block
  Params p{q,    k,    v,    o,    lse,  lengths, q_sb, q_st,
           q_sh, k_sb, k_st, k_sh, v_sb, v_st,    v_sh, B,
           T,    H,    (T + rows - 1) / rows, scale,
           Dropout{seed, thresh, inv_keep, drop_b0, drop_h0, drop_heads}};
  const unsigned grid = static_cast<unsigned>(B) * H * p.n_qt;
  if (grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    void (*kernel)(Params) = dropout ? fwd_bf16_kernel<true> : fwd_bf16_kernel<false>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kernel<<<grid, kFwdThreads, kFwdSmem, s>>>(p);
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
