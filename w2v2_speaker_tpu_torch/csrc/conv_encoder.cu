// Fused stride-2 conv + bias + LayerNorm + exact GELU for Hopper, sm_90a.
//
// Replaces: w2v2_speaker_tpu/ops/conv_encoder.py::_kernel (:120), launched by
// _forward (:198, pallas_call :241): wav2vec2's conv feature-encoder layers
// 1-6 (k = 3 or 2, stride 2, VALID, C -> C channels).
//
// Function: y[b, t, n] = GELU(LN(sum_{j < k*C} x[b, 2t + j / C, j % C] *
// W[j, n] + bias[n])), the LayerNorm over the C channels of a frame (mean,
// then the two-pass variance, eps, scale and shift), each of bias, LN and
// GELU optional; f32 accumulation and epilogue, one store in the input's
// type. x is channels-last [B, T_in, C], y [B, T_out, C], T_out =
// (T_in - k) / 2 + 1.
//
// The layout makes the conv one GEMM. In channels-last memory the k input
// frames of output frame t, x[2t .. 2t + k - 1], are k*C contiguous elements
// starting at x + (b * T_in + 2t) * C: row t of the GEMM's A is that run,
// and consecutive rows overlap, 2C elements apart. No pair-phase reshape and
// no seam row (the TPU kernel's answer to its (8, 128) tiling) are needed.
// W is the [k*C, C] matrix of the flax [k, C_in, C_out] kernel, repacked
// once on the host: bf16 as its transpose [C, k*C] (each output channel's
// contraction contiguous: the K-major B tile of wgmma), f32 as [k*C, C].
//
// Bound at the main paths' shapes (H100 SXM: 989 TFLOP/s bf16 dense,
// 3.35 TB/s): FLOPs = 2 * B * T_out * k * C^2 per layer, bytes = x, W and y
// moved once. Layers 1-6 at B=48 x 48 000 samples (wav2vec2-LARGE training):
// 702 GFLOP against 1.4 GB, so operations bound it, 0.71 ms; every layer is
// above the card's ~295 FLOP/byte ridge.
//
// bf16 design (the redesign of the first version's mma.sync kernel, whose
// synchronous load -> __syncthreads -> product loop ran at 10x the bound):
// - A block owns 64 frames x all C channels, because the LayerNorm needs a
//   frame's C outputs together. Three warpgroups: two consumers, each the
//   64 x C/2 wgmma accumulator of its half of the channels (m64nNk16, N =
//   C/2 <= 256: 128 f32 registers a thread at C = 512, 232 registers after
//   setmaxnreg), and one producer that keeps TMA loads in flight (40
//   registers).
// - The contraction runs in steps of 64 (one 128-byte swizzled row) through
//   a ring of shared-memory stages (3 at C = 512: 8 KB of A and C x 128 B of
//   W each, ~218 KB of dynamic shared memory) with full/empty mbarrier
//   pairs: the producer waits for a stage to be empty, posts its bytes and
//   starts the loads; the consumers wait for it to be full, run four wgmma
//   per half on it and release it. Loads of later stages overlap the
//   products of the current one.
// - A by TMA without a strided view: tap j of the conv reads input frame
//   2t + j for output row t, so each tap has its own 3-D tensor map over x,
//   [B][T_out][C] with a row stride of 2C elements starting at frame j
//   (x + j * C). A 64-deep step lies within one tap (C % 64 == 0), so the
//   step's box is 64 rows x 64 channels of one tap's map. Rows past T_out
//   (the ragged last tile, odd T_in) come back zero-filled from the copy
//   engine and never read past the batch row; they are not stored.
// - The epilogue stays in registers: bias, the LayerNorm's row sums across
//   each quad by shuffles and across the two consumer warpgroups through 1 KB
//   of shared memory under a named barrier of the 256 consumer threads (the
//   producer never joins it), the mean, then the variance of the centred
//   values, scale and shift, GELU with erff (CUDA has erf: the TPU kernel's
//   Abramowitz-Stegun polynomial, :64-80, is not carried over), one bf16
//   store per pair of channels, masked past T_out.
// - What bounds it, measured by tools/torch_conv_limits.py on an H100 80GB
//   HBM3 at 700 W (1.64 ms for layers 1-6 at B=48 against the 0.71 ms
//   bound): the A side of the pipeline. Leaving out the W stream from L2
//   or the products saves 5-6 % each, and the LayerNorm and GELU 9 %; a
//   variant that only loads A and runs the epilogue keeps 72 % of the
//   time. Each step's A box is 64 rows of 128 B, 2C apart, from HBM, and
//   the ring holds three steps of A and W: the shared memory bounds the
//   bytes in flight. Multicasting W across a cluster (less L2 traffic)
//   and a separate, deeper A ring (fewer W stages) were both slower.
// Tensor maps are encoded on the host per launch with cuTensorMapEncodeTiled,
// looked up at run time with cudaGetDriverEntryPoint (no -lcuda), and
// passed as a __grid_constant__ parameter.
//
// f32 (for the float32 checks, the first version's): scalar FMAs, 32-frame
// tiles, 256 threads as 8 row groups x 32 channel lanes, each thread 4
// frames x C/32 channels; a frame's channels all lie in one warp, so the
// LayerNorm's sums are warp shuffles.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxC = 512;
constexpr int kBM = 64;          // frames per block, bf16 (the wgmma M)
constexpr int kBK = 64;          // contraction step, bf16: one 128-byte row
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = 384;    // + the producer warpgroup
constexpr int kStageBudget = 220 * 1024;  // shared memory for the stage ring
constexpr int kBMf = 32;         // frames per block, f32
constexpr int kBKf = 16;         // contraction step, f32
// error codes past the CUDA runtime's, for conv_encoder_error
constexpr int kErrNoEncoder = 19999;
constexpr int kErrEncode = 20000;  // + the CUresult of cuTensorMapEncodeTiled

struct Params {
  const void* x;          // [B, T_in, C], the input type
  const void* w;          // bf16: [C, K]; f32: [K, C]
  const float* bias;      // [C] or null
  const float* ln_scale;  // [C] or null (then ln_bias is null too)
  const float* ln_bias;
  void* y;                // [B, T_out, C], the input type
  int B, T_in, T_out, C, K;  // K = k * C
  float eps;
  int gelu;
};

// The bf16 kernel's TMA descriptors: a[j] is tap j's [B][T_out][C] view of
// x (row t = input frame 2t + j; a[2] is a copy of a[0] when k = 2, never
// read), w the [C][K] weight.
struct TapMaps {
  CUtensorMap a[3];
  CUtensorMap w;
};

template <int C>
struct ConvShape {
  static constexpr int kN = C / 2;                 // channels per consumer (wgmma N)
  static constexpr int kABytes = kBM * kBK * 2;    // 8 KB
  static constexpr int kWBytes = C * kBK * 2;      // C rows of 128 B
  static constexpr int kStageBytes = kABytes + kWBytes;
  static constexpr int kStages = kStageBudget / kStageBytes < 6 ? kStageBudget / kStageBytes : 6;
  // + LN sums (1 KB), barriers (<= 96 B), 1 KB alignment slack
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 128 + 1024;
};

// Element (t, kk) of the GEMM's A for batch row b: x[b, 2t + kk / C, kk % C].
__device__ __forceinline__ long long a_offset(const Params& p, int b, int t, int kk) {
  return (static_cast<long long>(b) * p.T_in + 2LL * t) * p.C + kk;
}

__device__ __forceinline__ float ln_apply(float v, float mean, float rstd, float s, float lb) {
  return (v - mean) * rstd * s + lb;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    conv_encoder_bf16_kernel(const Params p, const __grid_constant__ TapMaps maps) {
  using S = ConvShape<C>;
  constexpr int kN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + S::kStages * S::kStageBytes);  // [2][2][kBM]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * kBM);
  uint64_t* empty = full + S::kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kBM;
  const int n_steps = p.K / kBK;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread starts every load
    setmaxnreg_dec<40>();
    if (tid == kConsumers) {
      for (int s = 0; s < n_steps; ++s) {
        const int stage = s % S::kStages;
        mbar_wait(&empty[stage], ((s / S::kStages) & 1) ^ 1);
        uint8_t* a_s = smem + stage * S::kStageBytes;
        uint8_t* w_s = a_s + S::kABytes;
        mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
        const int kk = s * kBK, tap = kk / C;
        tma_load_3d(a_s, &maps.a[tap], &full[stage], kk - tap * C, t0, b);
        tma_load_2d(w_s, &maps.w, &full[stage], kk, 0);
        tma_load_2d(w_s + kN * kBK * 2, &maps.w, &full[stage], kk, kN);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int half = tid >> 7;  // this warpgroup's channels: [half * kN, half * kN + kN)
    float acc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

    for (int s = 0; s < n_steps; ++s) {
      const int stage = s % S::kStages;
      mbar_wait(&full[stage], (s / S::kStages) & 1);
      const uint8_t* a_s = smem + stage * S::kStageBytes;
      const uint64_t da = desc_k_major(a_s);
      const uint64_t db = desc_k_major(a_s + S::kABytes + half * kN * kBK * 2);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kBK / 16; ++k16) wgmma_ss<kN>(acc, da + 2 * k16, db + 2 * k16, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
    }

    // epilogue: thread (warp wq of the warpgroup, g, t4) holds rows r0 = 16 wq
    // + g (acc[4 i], acc[4 i + 1]) and r0 + 8 (acc[4 i + 2], acc[4 i + 3]) at
    // channels col0 + 8 i + {0, 1}
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int r0 = ((tid & 127) >> 5) * 16 + g;
    const int col0 = half * kN + t4 * 2;
    if (p.bias) {
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const float b0 = p.bias[col0 + i * 8], b1 = p.bias[col0 + i * 8 + 1];
        acc[4 * i] += b0;
        acc[4 * i + 1] += b1;
        acc[4 * i + 2] += b0;
        acc[4 * i + 3] += b1;
      }
    }
    if (p.ln_scale) {
      const float inv_c = 1.f / static_cast<float>(C);
      float mean[2], rstd[2];
      // pass 0: the mean; pass 1: the variance of the centred values
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          float v = acc[i];
          if (pass == 1) {
            v -= mean[(i >> 1) & 1];
            v *= v;
          }
          part[(i >> 1) & 1] += v;
        }
        float* red_p = red + pass * 2 * kBM;  // [half][row]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
          part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
          if (t4 == 0) red_p[half * kBM + r0 + 8 * h] = part[h];
        }
        named_barrier(1, kConsumers);  // both halves' partial sums are in
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = red_p[r0 + 8 * h] + red_p[kBM + r0 + 8 * h];
          if (pass == 0)
            mean[h] = s * inv_c;
          else
            rstd[h] = rsqrtf(s * inv_c + p.eps);
        }
      }
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const int c = col0 + i * 8;
        const float s0 = p.ln_scale[c], s1 = p.ln_scale[c + 1];
        const float l0 = p.ln_bias[c], l1 = p.ln_bias[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * i + 2 * h] = ln_apply(acc[4 * i + 2 * h], mean[h], rstd[h], s0, l0);
          acc[4 * i + 2 * h + 1] = ln_apply(acc[4 * i + 2 * h + 1], mean[h], rstd[h], s1, l1);
        }
      }
    }

    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (t0 + row < p.T_out) {
        __nv_bfloat16* yrow = y + (static_cast<long long>(b) * p.T_out + t0 + row) * C + col0;
#pragma unroll
        for (int i = 0; i < kN / 8; ++i) {
          float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if (p.gelu) {
            v0 = gelu_exact(v0);
            v1 = gelu_exact(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(yrow + i * 8) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// f32: thread (ty = tid / 32, tx = tid % 32) owns frames ty + 8 i (i < 4) of a
// 32-frame tile and channels tx * 4 + 128 j + e (j < NJ = C / 128, e < 4).
template <int NJ>
__global__ void __launch_bounds__(256) conv_encoder_f32_kernel(Params p) {
  __shared__ __align__(16) float a_s[kBMf][kBKf + 4];
  __shared__ __align__(16) float w_s[kBKf][kMaxC];

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kBMf;
  const int n_rows = min(kBMf, p.T_out - t0);
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int c4 = p.C / 4;

  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBKf) {
    __syncthreads();
    if (tid < kBMf * kBKf / 4) {
      const int r = tid >> 2, col = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_rows) v = *reinterpret_cast<const float4*>(x + a_offset(p, b, t0 + r, k0 + col));
      *reinterpret_cast<float4*>(&a_s[r][col]) = v;
    }
    for (int c = tid; c < kBKf * c4; c += 256) {
      const int kr = c / c4, col = (c % c4) * 4;
      *reinterpret_cast<float4*>(&w_s[kr][col]) = *reinterpret_cast<const float4*>(
          w + static_cast<long long>(k0 + kr) * p.C + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKf; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[ty + 8 * i][kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(&w_s[kk][tx * 4 + 128 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(av[i], wv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(av[i], wv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(av[i], wv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(av[i], wv.w, acc[i][j][3]);
        }
      }
    }
  }

  if (p.bias) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bv = p.bias[tx * 4 + 128 * j + e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j][e] += bv;
      }
  }
  if (p.ln_scale) {
    const float inv_c = 1.f / static_cast<float>(p.C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s += acc[i][j][e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float mean = s * inv_c;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = acc[i][j][e] - mean;
          q += d * d;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
      const float rstd = rsqrtf(q * inv_c + p.eps);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = tx * 4 + 128 * j + e;
          acc[i][j][e] = ln_apply(acc[i][j][e], mean, rstd, p.ln_scale[c], p.ln_bias[c]);
        }
    }
  }

  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 8 * i;
    if (t0 + row < p.T_out) {
      float* yrow = y + (static_cast<long long>(b) * p.T_out + t0 + row) * p.C;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float4 v = make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
        if (p.gelu) {
          v.x = gelu_exact(v.x);
          v.y = gelu_exact(v.y);
          v.z = gelu_exact(v.z);
          v.w = gelu_exact(v.w);
        }
        *reinterpret_cast<float4*>(yrow + tx * 4 + 128 * j) = v;
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; byte strides of
// dimensions 1..), boxes `box`, 128-byte swizzle, zero fill out of bounds.
// Returns 0 or an error code of conv_encoder_error.
int encode_bf16(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int C>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using S = ConvShape<C>;
  TapMaps maps;
  const int k = p.K / C;
  for (int j = 0; j < k; ++j) {
    const int first = j;  // tap j starts at input frame j
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(p.T_out),
                                static_cast<cuuint64_t>(p.B)};
    // bytes: two frames apart; one batch row apart
    const cuuint64_t strides[2] = {4ull * C, 2ull * C * p.T_in};
    const cuuint32_t box[3] = {kBK, kBM, 1};
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(p.x) + first * C;
    if (const int e = encode_bf16(&maps.a[j], base, 3, dims, strides, box)) return e;
  }
  for (int j = k; j < 3; ++j) maps.a[j] = maps.a[0];
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(C)};
  const cuuint64_t wstrides[1] = {2ull * p.K};
  const cuuint32_t wbox[2] = {kBK, S::kN};
  if (const int e = encode_bf16(&maps.w, p.w, 2, wdims, wstrides, wbox)) return e;

  const cudaError_t attr = cudaFuncSetAttribute(
      conv_encoder_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.B, (p.T_out + kBM - 1) / kBM);
  conv_encoder_bf16_kernel<C><<<grid, kThreads, S::kSmem, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x, w and y in that type; bias, ln_scale
// and ln_bias f32 or null, ln_scale and ln_bias together). w: bf16 [C, k*C],
// f32 [k*C, C]. x, w and y contiguous and 16-byte aligned; C % 128 == 0,
// C <= 512, k in {2, 3}. Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a shape it does not take, or an error
// of the bf16 kernel's tensor maps (conv_encoder_error names each).
extern "C" int conv_encoder_fused(const void* x, const void* w, const float* bias,
                                  const float* ln_scale, const float* ln_bias, void* y,
                                  int B, int T_in, int T_out, int C, int k, float eps,
                                  int gelu, int dtype, void* stream) {
  if (C <= 0 || C % 128 != 0 || C > kMaxC || (k != 2 && k != 3) ||
      (ln_scale == nullptr) != (ln_bias == nullptr) || T_out > (T_in - k) / 2 + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || T_out <= 0) return 0;
  Params p{x, w, bias, ln_scale, ln_bias, y, B, T_in, T_out, C, k * C, eps, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (C) {
      case 128: return launch_bf16<128>(p, s);
      case 256: return launch_bf16<256>(p, s);
      case 384: return launch_bf16<384>(p, s);
      default: return launch_bf16<512>(p, s);
    }
  }
  const dim3 grid(B, (T_out + kBMf - 1) / kBMf);
  switch (C / 128) {
    case 1: conv_encoder_f32_kernel<1><<<grid, 256, 0, s>>>(p); break;
    case 2: conv_encoder_f32_kernel<2><<<grid, 256, 0, s>>>(p); break;
    case 3: conv_encoder_f32_kernel<3><<<grid, 256, 0, s>>>(p); break;
    default: conv_encoder_f32_kernel<4><<<grid, 256, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv_encoder_error(int code) {
  if (code == kErrNoEncoder) return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (code >= kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (the code minus 20000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
