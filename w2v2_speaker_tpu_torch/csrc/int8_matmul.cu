// Dynamic int8 matmul for Hopper, sm_90a: the row quantize and the int8 GEMM
// with its rescale epilogue.
//
// Replaces no Pallas kernel. w2v2_speaker_tpu/ops/quant.py::int8_matmul
// (:83) leaves its int8 dot (lax.dot_general into int32) and the quantize and
// rescale passes around it to XLA, which fuses them on the TPU. Here they are
// written by hand so that the quantize is one pass and the rescale never
// leaves registers: in PyTorch ops each would be several passes over the
// activations, and the int32 product a [M, N] tensor in memory.
//
// Function (w2v2_speaker_tpu_torch/ops/quant.py holds the plain versions, in
// the same order of float32 operations):
// - int8_quantize_rows: x [M, K] (bf16 or f32) -> q [M, K] int8 and
//   scales [M] f32: absmax of the row in f32, scale = absmax / 127 (1 for a
//   zero row), q = clip(rint(x / scale), -127, 127), rint rounding half to
//   even as jnp.round. It quantizes the activations per row (token) and the
//   weights [N, K] per output channel: a torch Linear weight's rows are the
//   reference's per-output-channel columns (kernel.T).
// - int8_gemm: a [M, K] int8 x b [N, K] int8 -> int32 sums, then
//   out[m, n] = (float(acc) * xs[m]) * ks[n] (+ bias[n]) rounded once to the
//   output type (bf16 or f32). __fmul_rn / __fadd_rn keep nvcc from
//   contracting the epilogue into an FMA, so the output is bit-equal to the
//   plain version (the int32 sum is exact at these K: |acc| <= 127^2 K).
//
// Bound at the main paths' shapes (H100 SXM: 1,979 TOP/s int8 dense,
// 3.35 TB/s): the GEMM moves M K + N K bytes in, M N out (2 or 4 bytes) and
// does 2 M N K operations. At wav2vec2-LARGE's intermediate dense (M = 4 x
// 1499, K = 1024, N = 4096) that is 50 GOP against 59 MB: operations bound
// it (25 us against 18 us of bytes). The card's ridge lies at ~590 int8
// operations a byte, so the narrow sites (BASE's N = K = 768, ~490 a byte
// with a bf16 output) are bound by their bytes. The quantize reads x once and
// writes q and the scales: bytes bound it.
//
// Design (correct and simple first; wgmma and TMA are later work):
// - Quantize: one warp per row, 8 rows a block. The absmax reduction by
//   shuffles, then a second pass over the row (from L1/L2) writes q. IEEE
//   division (__fdiv_rn) and rintf, never --use_fast_math.
// - GEMM: 128 x 128 output tiles, 8 warps of 64 x 32, each a 4 x 4 grid of
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32 products (A row-major [M, K], B
//   "col" [N, K]: the operand layout of both quantized tensors as they are).
//   The contraction runs in steps of 64 bytes through two shared-memory
//   stages filled by cp.async 16-byte copies, the next step's copies in
//   flight during this step's products. Shared rows are padded to 80 bytes,
//   so the fragment loads of the 8 rows of a group hit 32 distinct banks.
//   Rows past M or N and columns past K are zero-filled by the copies (an
//   int8 zero adds nothing) and never stored. K must be a multiple of 16 (the
//   16-byte copies stay aligned); the wrapper pads a ragged K with zeros.
// - The epilogue rescales each int32 sum in registers and stores it once.

#include "hopper.cuh"

namespace {

constexpr int kQuantRows = 8;  // rows (warps) per quantize block
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kLd = kBK + 16;  // shared row stride in bytes (bank-conflict-free fragments)
constexpr int kErrShape = 10001;  // error codes past the CUDA runtime's

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kQuantRows * 32)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                         int M, int K) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kQuantRows + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + row * K;
  float absmax = 0.f;
  for (int k = lane; k < K; k += 32) absmax = fmaxf(absmax, fabsf(to_f32(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
  const float scale = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
  int8_t* qr = q + row * K;
  for (int k = lane; k < K; k += 32) {
    const float v = fminf(fmaxf(rintf(__fdiv_rn(to_f32(xr[k]), scale)), -127.f), 127.f);
    qr[k] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (lane == 0) scales[row] = scale;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + kBM) of a [rows, K] int8 matrix, bytes [k0, k0 + kBK), into
// a kLd-strided shared tile: 512 chunks of 16 bytes, 2 per thread
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int rows, int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, kc = (c & 3) * 16;
    const bool ok = r0 + r < rows && k0 + kc < K;
    cp_async_16(dst + r * kLd + kc, ok ? src + static_cast<long long>(r0 + r) * K + k0 + kc : src, ok);
  }
}

template <typename OutT>
__device__ __forceinline__ void store(OutT* out, long long i, float v);
template <>
__device__ __forceinline__ void store<float>(float* out, long long i, float v) {
  out[i] = v;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                     const float* __restrict__ xs, const float* __restrict__ ks,
                     const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[2][kBM * kLd];
  __shared__ __align__(16) int8_t Bs[2][kBN * kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment group and thread in group
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (K + kBK - 1) / kBK;
  load_tile(As[0], A, M, K, m0, 0);
  load_tile(Bs[0], B, N, K, n0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {  // the next step's copies, in flight during this step's products
      load_tile(As[(s + 1) & 1], A, M, K, m0, (s + 1) * kBK);
      load_tile(Bs[(s + 1) & 1], B, N, K, n0, (s + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* as = As[s & 1];
    const int8_t* bs = Bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (wm + i * 16 + g) * kLd + kk + tig * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kLd);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn + j * 8 + g) * kLd + kk + tig * 4;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // fragment rows g and g + 8
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float xm = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + tig * 2 + e;
          if (n >= N) continue;
          float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), xm), ks[n]);
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          store(out, static_cast<long long>(m) * N + n, v);
        }
      }
    }
  }
}

}  // namespace

// x [M, K] (dtype 0 = bf16, 1 = f32) -> q [M, K] int8, scales [M] f32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int int8_quantize_rows(const void* x, int dtype, void* q, float* scales, int M, int K,
                                  void* stream) {
  if (M < 0 || K <= 0 || (dtype != 0 && dtype != 1)) return kErrShape;
  if (M == 0) return 0;
  const dim3 grid((M + kQuantRows - 1) / kQuantRows);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quantize_rows_kernel<__nv_bfloat16><<<grid, kQuantRows * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), scales, M, K);
  else
    quantize_rows_kernel<float><<<grid, kQuantRows * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), scales, M, K);
  return static_cast<int>(cudaGetLastError());
}

// a [M, K] int8, b [N, K] int8 (K % 16 == 0, both 16-byte aligned), xs [M],
// ks [N], bias [N] or null, all f32 -> out [M, N] (out_dtype 0 = bf16,
// 1 = f32). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int int8_gemm(const void* a, const void* b, const float* xs, const float* ks,
                         const float* bias, void* out, int out_dtype, int M, int N, int K,
                         void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 || (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return kErrShape;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const int8_t*>(a);
  const auto* B = static_cast<const int8_t*>(b);
  if (out_dtype == 0)
    int8_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(A, B, xs, ks, bias,
                                                              static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    int8_gemm_kernel<float><<<grid, kThreads, 0, s>>>(A, B, xs, ks, bias, static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error(int code) {
  if (code == kErrShape)
    return "int8_matmul: a shape, type or alignment the kernels do not take (K % 16, 16-byte operands)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
