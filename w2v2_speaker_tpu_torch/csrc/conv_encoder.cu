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
// contraction contiguous, the column-major B operand of the mma), f32 as
// [k*C, C].
//
// Bound at the main paths' shapes (H100 SXM: 989 TFLOP/s bf16 dense,
// 3.35 TB/s): FLOPs = 2 * B * T_out * k * C^2 per layer, bytes = x, W and y
// moved once. Layers 1-6 at B=48 x 48 000 samples (wav2vec2-LARGE training):
// 702 GFLOP against 1.4 GB, so operations bound it, 0.71 ms; every layer is
// above the card's ~295 FLOP/byte ridge. The design's answer to an
// operation-bound GEMM is the tensor cores with both operands staged in
// shared memory and 64 frames x C channels of f32 accumulators per block,
// so each weight byte fetched from L2 feeds 64 frames. The LayerNorm needs
// a frame's C outputs together, so one block owns all C channels of its
// frames. Not done yet (later work): wgmma, TMA or cp.async pipelining,
// overlap of loads with the products.
//
// Design (first version: right and simple):
// - grid (batch row, 64-frame tile), the batch row fastest; frames >= T_out
//   of the last tile are neither loaded (zero-filled) nor stored;
// - bf16: C / 64 warps, warp w owns output channels [64 w, 64 w + 64) of all
//   64 frames (4 x 8 mma.sync m16n8k16 tiles, bf16 in, f32 accumulate, 128
//   accumulators a thread); the contraction runs in steps of 32, A (64 x 32)
//   and W (C x 32) staged in padded shared memory (80-byte rows: the
//   fragment reads are bank-conflict free);
// - epilogue in registers: bias, the row sums across the quad by shuffles
//   and across warps through shared memory, mean, then the variance of the
//   centred values, scale and shift, GELU with erff (CUDA has erf: the TPU
//   kernel's Abramowitz-Stegun polynomial, :64-80, is not carried over);
// - f32 (for the float32 checks): scalar FMAs, 32-frame tiles, 256 threads
//   as 8 row groups x 32 channel lanes, each thread 4 frames x C/32
//   channels; a frame's channels all lie in one warp, so the LayerNorm's
//   sums are warp shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 512;
constexpr int kBM = 64;        // frames per block, bf16
constexpr int kBK = 32;        // contraction step, bf16
constexpr int kLdk = kBK + 8;  // padded shared row, bf16 elements (80 bytes)
constexpr int kBMf = 32;       // frames per block, f32
constexpr int kBKf = 16;       // contraction step, f32

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

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
// Fragments (g = lane / 4, t4 = lane % 4): a0 = A[g][2t4..], a1 = A[g+8][2t4..],
// a2 = A[g][2t4+8..], a3 = A[g+8][2t4+8..]; b0 = B[2t4..][g], b1 = B[2t4+8..][g];
// c0, c1 = C[g][2t4..], c2, c3 = C[g+8][2t4..].
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(256, 1) conv_encoder_bf16_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kBM * kLdk];
  __shared__ __align__(16) __nv_bfloat16 w_s[kMaxC * kLdk];
  __shared__ float red_s[kMaxC / 64][kBM];

  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kBM;
  const int n_rows = min(kBM, p.T_out - t0);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    __syncthreads();  // the previous step's readers are done
    for (int c = tid; c < kBM * (kBK / 8); c += nthreads) {
      const int r = c >> 2, col = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows)
        v = *reinterpret_cast<const uint4*>(x + a_offset(p, b, t0 + r, k0 + col));
      *reinterpret_cast<uint4*>(a_s + r * kLdk + col) = v;
    }
    for (int c = tid; c < p.C * (kBK / 8); c += nthreads) {
      const int n = c >> 2, col = (c & 3) * 8;
      *reinterpret_cast<uint4*>(w_s + n * kLdk + col) = *reinterpret_cast<const uint4*>(
          w + static_cast<long long>(n) * p.K + k0 + col);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* base = a_s + (mi * 16 + g) * kLdk + kk + t4 * 2;
        af[mi][0] = ld32(base);
        af[mi][1] = ld32(base + 8 * kLdk);
        af[mi][2] = ld32(base + 8);
        af[mi][3] = ld32(base + 8 * kLdk + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const __nv_bfloat16* bb = w_s + (warp * 64 + ni * 8 + g) * kLdk + kk + t4 * 2;
        const uint32_t b0 = ld32(bb), b1 = ld32(bb + 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }

  // epilogue: thread (warp, g, t4) holds rows mi * 16 + g (elements 0, 1) and
  // mi * 16 + g + 8 (elements 2, 3) at channels warp * 64 + ni * 8 + 2 t4 + {0, 1}
  const int col0 = warp * 64 + t4 * 2;
  if (p.bias) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float b0 = p.bias[col0 + ni * 8], b1 = p.bias[col0 + ni * 8 + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        acc[mi][ni][0] += b0;
        acc[mi][ni][1] += b1;
        acc[mi][ni][2] += b0;
        acc[mi][ni][3] += b1;
      }
    }
  }
  if (p.ln_scale) {
    const float inv_c = 1.f / static_cast<float>(p.C);
    float mean[4][2], rstd[4][2];
    // pass 0: the mean; pass 1: the variance of the centred values
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float part[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        part[mi][0] = part[mi][1] = 0.f;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = acc[mi][ni][e];
            if (pass == 1) {
              v -= mean[mi][e >> 1];
              v *= v;
            }
            part[mi][e >> 1] += v;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[mi][h] += __shfl_xor_sync(0xffffffffu, part[mi][h], 1);
          part[mi][h] += __shfl_xor_sync(0xffffffffu, part[mi][h], 2);
        }
      }
      __syncthreads();  // red_s is free (the previous pass has read it)
      if (t4 == 0) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          red_s[warp][mi * 16 + g] = part[mi][0];
          red_s[warp][mi * 16 + g + 8] = part[mi][1];
        }
      }
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
          for (int ww = 0; ww < nwarps; ++ww) s += red_s[ww][mi * 16 + g + h * 8];
          if (pass == 0)
            mean[mi][h] = s * inv_c;
          else
            rstd[mi][h] = rsqrtf(s * inv_c + p.eps);
        }
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int c = col0 + ni * 8;
      const float s0 = p.ln_scale[c], s1 = p.ln_scale[c + 1];
      const float l0 = p.ln_bias[c], l1 = p.ln_bias[c + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[mi][ni][2 * h] = ln_apply(acc[mi][ni][2 * h], mean[mi][h], rstd[mi][h], s0, l0);
          acc[mi][ni][2 * h + 1] =
              ln_apply(acc[mi][ni][2 * h + 1], mean[mi][h], rstd[mi][h], s1, l1);
        }
    }
  }

  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mi * 16 + g + h * 8;
      if (t0 + row < p.T_out) {
        __nv_bfloat16* yrow =
            y + (static_cast<long long>(b) * p.T_out + t0 + row) * p.C + col0;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if (p.gelu) {
            v0 = gelu_exact(v0);
            v1 = gelu_exact(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(yrow + ni * 8) = __floats2bfloat162_rn(v0, v1);
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

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x, w and y in that type; bias, ln_scale
// and ln_bias f32 or null, ln_scale and ln_bias together). w: bf16 [C, k*C],
// f32 [k*C, C]. x, w and y contiguous and 16-byte aligned; C % 128 == 0,
// C <= 512, k in {2, 3}. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a shape it does not take.
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
    const dim3 grid(B, (T_out + kBM - 1) / kBM);
    conv_encoder_bf16_kernel<<<grid, C / 2, 0, s>>>(p);
  } else {
    const dim3 grid(B, (T_out + kBMf - 1) / kBMf);
    switch (C / 128) {
      case 1: conv_encoder_f32_kernel<1><<<grid, 256, 0, s>>>(p); break;
      case 2: conv_encoder_f32_kernel<2><<<grid, 256, 0, s>>>(p); break;
      case 3: conv_encoder_f32_kernel<3><<<grid, 256, 0, s>>>(p); break;
      default: conv_encoder_f32_kernel<4><<<grid, 256, 0, s>>>(p); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv_encoder_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
