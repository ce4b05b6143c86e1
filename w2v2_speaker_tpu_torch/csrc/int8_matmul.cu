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
//   plain version (the int32 sum is exact in any order: |acc| <= 127^2 K).
//
// Bound at the main paths' shapes (H100 SXM: 1,979 TOP/s int8 dense,
// 3.35 TB/s): the GEMM moves M K + N K bytes in, M N out (2 or 4 bytes) and
// does 2 M N K operations. At wav2vec2-LARGE's five dense sites (M = 4 x
// 1449) that is 152 GOP against ~176 MB: operations bound it (77 us against
// 53 us of bytes, 35 us of them the bf16 output). The card's ridge lies at
// ~590 int8 operations a byte, so the narrow sites (BASE's N = K = 768, ~490
// a byte with a bf16 output) are bound by their bytes. The quantize reads x
// once and writes q and the scales: bytes bound it.
//
// GEMM design (the redesign of the first version's mma.sync kernel: 128 x
// 128 tiles, a 64-byte step through two cp.async stages, 4-byte fragment
// loads, at 14.5 % of its bound):
// - Operands by TMA: 2-D tensor maps over A [M, K] and B [N, K] (both
//   K-major, the only layout wgmma takes for 8-bit types), 128-byte swizzle,
//   encoded per launch and passed as __grid_constant__. A 128-byte swizzled
//   row is 128 int8 of the contraction, so a stage is one such row of each
//   operand's tile and a k32 product steps 32 bytes along it. The copy engine
//   zero-fills the ragged M, N and K edges (an int8 zero adds nothing); K %
//   16 == 0 gives TMA its 16-byte row stride (the wrapper pads K).
// - A ring of 128-byte stages (4-8, ~192 KB) with a full/empty mbarrier
//   pair each. One producer thread (its warpgroup at 40 registers) keeps TMA
//   loads in flight; two consumer warpgroups (232 registers) run
//   wgmma.m64nNk32.s32.s8.s8 on the upper and lower 64 rows of a 128 x N
//   tile, one commit group of four products a stage, each stage released
//   (one arrival a warp) once the next stage's group is issued (wait_group 1).
// - Persistent blocks, one a SM, walk the output tiles (M fastest, so the
//   blocks in flight share B tiles in L2); the producer runs ahead into the
//   next tile's stages while the consumers rescale and store this one.
// - The epilogue: each warpgroup stages the tile's ks, bias and its rows' xs
//   in shared memory (read from global memory while the products run), each
//   thread rescales its accumulators in registers, and each warp writes its
//   16 rows, 64 bytes of columns at a time, into its own two 64-byte-swizzled
//   shared-memory chunks, which the copy engine stores (TMA, clipping the
//   ragged edges) while the warp writes the next. Rows that are not 16-byte
//   multiples (N odd, or not a multiple of 8 in bf16) take one store an
//   element instead.
// - The tile width N is chosen per launch (`tile_n`): of 256, 192, 128 and
//   64, the one with the fewest tiles on the busiest SM times the bytes a
//   tile's stage loads (128 + N rows of 128 bytes), the narrower on a tie.
//   Measured at LARGE's and BASE's ten sites (tools/torch_int8_limits.py),
//   the rule picks the fastest width at every one.
// - What holds it (tools/torch_int8_limits.py on an H100 80GB HBM3 at 700 W,
//   LARGE's five sites summed; PERF.md has the numbers): the TMA ring alone
//   (loads and barriers, no products, no epilogue) takes two thirds of the
//   kernel's time, the products add little on top of it, and the rest is the
//   epilogue, which starts after its tile's last product. Each SM takes in
//   ~70-90 GB/s of operands through the ring. Three designs were slower in
//   trials: a cluster of two blocks sharing each B tile by multicast (half
//   the L2 reads: what each SM receives, not L2, sets the pace), a lag of one
//   consumer warpgroup behind the other, and ping-pong warpgroups on 128 x
//   128 tiles (the epilogue hidden, but a third more bytes loaded a product).
//   Shared memory holds no deeper ring: the stages, the output chunks and the
//   staged ks, bias and xs take ~220 of the 227 KB.
//
// Quantize design (the redesign of the first version's warp a row, scalar
// loads, two passes over the row and 1-byte stores):
// - tpr threads a row (a power of two, 32-256), each holding up to four
//   16-byte vectors of the row (8 bf16 or 4 f32; neighbouring threads on
//   neighbouring addresses) in registers: the row is read once. Rows of up
//   to 4 x 256 vectors fit; a longer row reads its later chunks twice.
// - Persistent 256-thread blocks (as many as the card holds) step through
//   the rows, several rows a block where tpr < 256, and load a row's first
//   chunk while the row before it is quantized.
// - The absmax by warp shuffles and one shared slot a warp.
// - q stored as one 8-byte (bf16) or 4-byte (f32) word a vector. A row that
//   is not 16-byte aligned (K not a multiple of 8 or 4) takes the same
//   kernel with one element a load.
// - IEEE division (__fdiv_rn) and rintf, never --use_fast_math: a reciprocal
//   multiply would change q's bits against the plain version. The division
//   costs ~25 % of the kernel's time at these shapes (the no_division
//   variant of tools/torch_int8_limits.py); the weights' launches are a few
//   microseconds each, where the launch, not the bytes, sets the time.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;          // tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;          // contraction bytes a stage: one 128-byte swizzled row
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // + the producer warpgroup
constexpr int kRingBudget = 200 * 1024;
constexpr int kOutChunkRow = 64;                // bytes of an output chunk's row
constexpr int kOutChunk = 16 * kOutChunkRow;    // a consumer warp's 16 rows of one output chunk
constexpr int kQuantBlock = 256;  // threads of a quantize block: a row's (tpr <= 256) or several rows'
constexpr int kQuantNV = 4;       // 16-byte vectors a thread holds
constexpr int kErrShape = 10001;  // error codes past the CUDA runtime's
constexpr int kErrNoEncoder = 10002;
constexpr int kErrEncode = 20000;  // + the CUresult of cuTensorMapEncodeTiled

constexpr int kMaxDevices = 64;

// The current device (0 if the runtime cannot say). Launch set-up that the
// runtime answers slowly is looked up once a device and kept.
int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : 0;
}

int sm_count() {
  static int sms[kMaxDevices] = {};
  const int dev = current_device();
  if (sms[dev] <= 0 && (cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
                        sms[dev] <= 0))
    sms[dev] = 132;
  return sms[dev];
}

// ------------------------------------------------------------- quantize
template <typename T, int VEC>
struct Row;  // one load of VEC elements of T (Raw), and the same as float

template <>
struct Row<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
};

template <>
struct Row<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Row<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
};

template <>
struct Row<__nv_bfloat16, 1> {
  using Raw = uint16_t;  // Raw{} is zero
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint16_t*>(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[1]) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
};

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* q, const float (&v)[VEC], float scale) {
  uint32_t w[(VEC + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[e], scale)), -127.f), 127.f);
    w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(r))))
                << (8 * (e % 4));
  }
  if constexpr (VEC == 8)
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  else if constexpr (VEC == 4)
    *reinterpret_cast<uint32_t*>(q) = w[0];
  else
    *q = static_cast<int8_t>(w[0]);
}

// The block takes rows base + threadIdx.x / tpr for base = blockIdx.x *
// rows, then a grid's worth of rows further, and so on; thread j of a row
// holds its vectors j + i * tpr (i < NV) of each chunk of tpr * NV vectors,
// and loads its next row's first chunk before it quantizes this one.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kQuantBlock)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                         int M, int K, int tpr) {
  using R = Row<T, VEC>;
  __shared__ float red[2][kQuantBlock / 32];  // a slot a warp, alternating between rows
  const int rows = kQuantBlock / tpr, lr = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5;
  const int nvec = K / VEC, chunk = tpr * NV;
  const long long stride = static_cast<long long>(gridDim.x) * rows;

  typename R::Raw cur[NV], nxt[NV];
  const long long first = static_cast<long long>(blockIdx.x) * rows + lr;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    cur[i] = first < M && j + i * tpr < nvec ? R::load(x + first * K + (j + i * tpr) * VEC) : typename R::Raw{};

  int par = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * rows; base < M; base += stride, par ^= 1) {
    const long long row = base + lr, next = row + stride;
    const bool valid = row < M;
    const T* xr = x + row * K;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      nxt[i] = next < M && j + i * tpr < nvec ? R::load(x + next * K + (j + i * tpr) * VEC) : typename R::Raw{};

    float absmax = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[VEC];
      R::unpack(cur[i], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) absmax = fmaxf(absmax, fabsf(v[e]));
    }
    for (int c0 = chunk; valid && c0 < nvec; c0 += chunk)  // rows past tpr * NV vectors
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = c0 + j + i * tpr;
        if (c < nvec) {
          float v[VEC];
          R::unpack(R::load(xr + c * VEC), v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) absmax = fmaxf(absmax, fabsf(v[e]));
        }
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
    if (wpr > 1) {  // the row's warps meet in shared memory
      if ((threadIdx.x & 31) == 0) red[par][warp] = absmax;
      __syncthreads();
      absmax = red[par][lr * wpr];
      for (int w = 1; w < wpr; ++w) absmax = fmaxf(absmax, red[par][lr * wpr + w]);
    }

    if (valid) {
      const float scale = absmax > 0.f ? __fdiv_rn(absmax, 127.f) : 1.f;
      int8_t* qr = q + row * K;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = j + i * tpr;
        if (c < nvec) {
          float v[VEC];
          R::unpack(cur[i], v);
          store_q<VEC>(qr + c * VEC, v, scale);
        }
      }
      for (int c0 = chunk; c0 < nvec; c0 += chunk)
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = c0 + j + i * tpr;
          if (c < nvec) {
            float v[VEC];
            R::unpack(R::load(xr + c * VEC), v);
            store_q<VEC>(qr + c * VEC, v, scale);
          }
        }
      if (j == 0) scales[row] = scale;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int VEC, int NV>
int launch_quantize_nv(const T* x, int8_t* q, float* scales, int M, int K, int tpr, cudaStream_t s) {
  auto kernel = quantize_rows_kernel<T, VEC, NV>;
  const long long groups = (M + kQuantBlock / tpr - 1) / (kQuantBlock / tpr);
  static int per_sm[kMaxDevices] = {};  // the blocks a SM holds at once
  int& held = per_sm[current_device()];
  if (held <= 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&held, kernel, kQuantBlock, 0) != cudaSuccess ||
                    held <= 0))
    held = 1;
  const long long resident = static_cast<long long>(sm_count()) * held;  // the blocks the card holds at once
  kernel<<<static_cast<unsigned>(groups < resident ? groups : resident), kQuantBlock, 0, s>>>(x, q, scales, M, K,
                                                                                              tpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_quantize(const T* x, int8_t* q, float* scales, int M, int K, cudaStream_t s) {
  const int nvec = K / VEC;
  int tpr = 32;
  while (tpr < kQuantBlock && tpr * kQuantNV < nvec) tpr *= 2;
  const int nv = (nvec + tpr - 1) / tpr < kQuantNV ? (nvec + tpr - 1) / tpr : kQuantNV;
  switch (nv) {
    case 1: return launch_quantize_nv<T, VEC, 1>(x, q, scales, M, K, tpr, s);
    case 2: return launch_quantize_nv<T, VEC, 2>(x, q, scales, M, K, tpr, s);
    case 3: return launch_quantize_nv<T, VEC, 3>(x, q, scales, M, K, tpr, s);
    default: return launch_quantize_nv<T, VEC, 4>(x, q, scales, M, K, tpr, s);
  }
}

// ------------------------------------------------------------------ GEMM
template <int BN>
struct GemmShape {
  static constexpr int kABytes = kBM * kBK;  // 16 KB
  static constexpr int kStageBytes = kABytes + BN * kBK;
  static constexpr int kStages = kRingBudget / kStageBytes < 8 ? kRingBudget / kStageBytes : 8;
  static constexpr int kEpiFloats = 2 * BN + 64;  // a warpgroup's ks, bias and xs of a tile
  // + the output chunks (two a consumer warp), each warpgroup's ks, bias and
  // xs of two tiles, the barriers, 1 KB alignment slack
  static constexpr int kSmem = kStages * kStageBytes + 16 * kOutChunk + 4 * kEpiFloats * 4 + 256 + 1024;
};

struct GemmParams {
  const float* xs;    // [M]
  const float* ks;    // [N]
  const float* bias;  // [N] or null
  void* out;          // [M, N], OutT
  int M, N, K;
};

struct GemmMaps {
  CUtensorMap a;    // [M][K] int8, boxes of 128 rows x 128 bytes
  CUtensorMap b;    // [N][K] int8, boxes of BN rows x 128 bytes
  CUtensorMap out;  // [M][N] OutT, boxes of 16 rows x 64 bytes (64-byte swizzle); unused without `tma_out`
};

__device__ __forceinline__ float rescale(int acc, float xm, float k, float b, bool has_bias) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xm), k);
  return has_bias ? __fadd_rn(v, b) : v;
}

template <typename OutT>
__device__ __forceinline__ void store_one(OutT* o, float v);
template <>
__device__ __forceinline__ void store_one<float>(float* o, float v) {
  *o = v;
}
template <>
__device__ __forceinline__ void store_one<__nv_bfloat16>(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// A column pair (v0, v1) of row r into an output chunk: 16 rows of 64 bytes
// in the 64-byte swizzle (16-byte unit u of row r at u ^ ((r / 2) % 4)), the
// pair's first byte at `byte` of the row.
template <typename OutT>
__device__ __forceinline__ void chunk_pair(uint8_t* chunk, int r, int byte, float v0, float v1);
template <>
__device__ __forceinline__ void chunk_pair<__nv_bfloat16>(uint8_t* chunk, int r, int byte, float v0, float v1) {
  const int at = r * 64 + ((((byte >> 4) ^ (r >> 1)) & 3) << 4) + (byte & 15);
  *reinterpret_cast<__nv_bfloat162*>(chunk + at) = __floats2bfloat162_rn(v0, v1);
}
template <>
__device__ __forceinline__ void chunk_pair<float>(uint8_t* chunk, int r, int byte, float v0, float v1) {
  const int at = r * 64 + ((((byte >> 4) ^ (r >> 1)) & 3) << 4) + (byte & 15);
  *reinterpret_cast<float2*>(chunk + at) = make_float2(v0, v1);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const GemmParams p, const __grid_constant__ GemmMaps maps, int tma_out) {
  using S = GemmShape<BN>;
  constexpr int kChunkCols = kOutChunkRow / static_cast<int>(sizeof(OutT));  // 32 bf16 or 16 f32
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* chunks = smem + S::kStages * S::kStageBytes;             // [8 consumer warps][2][kOutChunk]
  float* epi = reinterpret_cast<float*>(chunks + 16 * kOutChunk);   // [2 warpgroups][2][ks | bias | xs]
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 4 * S::kEpiFloats);
  uint64_t* empty = full + S::kStages;

  const int tid = threadIdx.x;
  const int tiles_m = (p.M + kBM - 1) / kBM;
  const int tiles = tiles_m * ((p.N + BN - 1) / BN);
  const int k_steps = (p.K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread starts every load
    setmaxnreg_dec<40>();
    if (tid == kConsumers) {
      int it = 0;  // stages filled so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * BN;
        for (int s = 0; s < k_steps; ++s, ++it) {
          const int stage = it % S::kStages;
          mbar_wait(&empty[stage], ((it / S::kStages) & 1) ^ 1);
          uint8_t* a_s = smem + stage * S::kStageBytes;
          mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
          tma_load_2d(a_s, &maps.a, &full[stage], s * kBK, m0);
          tma_load_2d(a_s + S::kABytes, &maps.b, &full[stage], s * kBK, n0);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, tw = tid & 127;  // this warpgroup's rows of the tile: [64 wg, 64 wg + 64)
    const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
    const int rw = (warp & 3) * 16 + (lane >> 2);  // the thread's first row within the warpgroup's 64
    const bool has_bias = p.bias != nullptr;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    int it = 0, t = 0, c_out = 0;  // stages consumed (in the producer's order); tiles; chunks stored
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++t) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * BN;
      // this tile's ks and bias (columns tw, tw + 128) and the warpgroup's
      // xs (row tw), read now and staged after the products
      float e_k[2] = {0.f, 0.f}, e_b[2] = {0.f, 0.f}, e_x = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = tw + 128 * h;
        if (col < BN && n0 + col < p.N) {
          e_k[h] = p.ks[n0 + col];
          e_b[h] = has_bias ? p.bias[n0 + col] : 0.f;
        }
      }
      if (tw < 64 && m0 + 64 * wg + tw < p.M) e_x = p.xs[m0 + 64 * wg + tw];

      for (int s = 0; s < k_steps; ++s, ++it) {
        const int stage = it % S::kStages;
        mbar_wait(&full[stage], (it / S::kStages) & 1);
        const uint8_t* a_s = smem + stage * S::kStageBytes;
        const uint64_t da = desc_k_major(a_s + wg * 64 * kBK);
        const uint64_t db = desc_k_major(a_s + S::kABytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k32 = 0; k32 < kBK / 32; ++k32) wgmma_ss_s8<BN>(acc, da + 2 * k32, db + 2 * k32, s | k32);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_regs(acc);
        if (s > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S::kStages]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % S::kStages]);

      // epilogue: thread (warp of the warpgroup, g = lane / 4, t4) holds rows
      // rw (acc[4 i], acc[4 i + 1]) and rw + 8 (acc[4 i + 2], acc[4 i + 3]) of
      // the warpgroup's 64 at columns n0 + 8 i + 2 t4 + {0, 1}. Each
      // warpgroup stages its own ks, bias and xs, for two tiles, so that one
      // a tile ahead never overwrites what the other still reads.
      float* e = epi + (2 * wg + (t & 1)) * S::kEpiFloats;  // [ks | bias | xs]
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (tw + 128 * h < BN) e[tw + 128 * h] = e_k[h], e[BN + tw + 128 * h] = e_b[h];
      if (tw < 64) e[2 * BN + tw] = e_x;
      named_barrier(1 + wg, 128);
      const float xm[2] = {e[2 * BN + rw], e[2 * BN + rw + 8]};
      if (tma_out) {
        // each warp's 16 rows in chunks of kChunkCols columns through its
        // own two shared-memory buffers, each stored by the copy engine
        // (which clips the ragged edges) while the next is written; a buffer
        // is rewritten once its store two chunks back has read it
#pragma unroll
        for (int c = 0; c < BN / kChunkCols; ++c, ++c_out) {
          if (n0 + c * kChunkCols >= p.N) break;
          uint8_t* chunk = chunks + (2 * warp + (c_out & 1)) * kOutChunk;
          if (lane == 0) bulk_wait_read<1>();
          __syncwarp();
#pragma unroll
          for (int i = 0; i < kChunkCols / 8; ++i) {
            const int q = c * (kChunkCols / 8) + i;  // the pair's 8-column group: acc[4 q ...]
            const int col = 8 * q + 2 * t4;           // its first column in the tile
            const float2 k = *reinterpret_cast<const float2*>(e + col);
            const float2 b = *reinterpret_cast<const float2*>(e + BN + col);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              chunk_pair<OutT>(chunk, (lane >> 2) + 8 * h, (8 * i + 2 * t4) * static_cast<int>(sizeof(OutT)),
                               rescale(acc[4 * q + 2 * h], xm[h], k.x, b.x, has_bias),
                               rescale(acc[4 * q + 2 * h + 1], xm[h], k.y, b.y, has_bias));
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) tma_store_2d(&maps.out, chunk, n0 + c * kChunkCols, m0 + 64 * wg + (warp & 3) * 16);
        }
      } else {
        // rows that are not 16-byte aligned: one store an element
        OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = 8 * i + 2 * t4 + c, row = m0 + 64 * wg + rw + 8 * h;
              if (n0 + col < p.N && row < p.M)
                store_one(out + static_cast<long long>(row) * p.N + n0 + col,
                          rescale(acc[4 * i + 2 * h + c], xm[h], e[col], e[BN + col], has_bias));
            }
      }
    }
    if (lane == 0) bulk_wait_all();  // the last stores have read their chunks before the block ends
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

// A [rows][cols] tensor map of `type` (`elem` bytes an element), boxes of
// box_rows x box_bytes, zero fill out of bounds. Returns 0 or an
// int8_matmul_error code.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rows, int cols,
              int box_rows, int box_bytes, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes / elem), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}


// The launch rule: the tile width of the fewest tiles on the busiest SM
// times the bytes a stage of the tile loads (kBM + bn rows of 128 bytes,
// what L2 must feed the SM), the narrower on a tie.
int tile_n(int M, int N, int sms) {
  static constexpr int kWidths[4] = {256, 192, 128, 64};
  int best = kWidths[0];
  long long best_cost = -1;
  for (const int bn : kWidths) {
    const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * (kBM + bn);
    if (best_cost < 0 || cost <= best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <int BN, typename OutT>
int launch_gemm(const GemmParams& p, const void* a, const void* b, int sms, cudaStream_t stream) {
  using S = GemmShape<BN>;
  constexpr bool kF32 = sizeof(OutT) == 4;
  GemmMaps maps;
  if (const int e = encode_2d(&maps.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, p.M, p.K, kBM, kBK,
                              CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  if (const int e = encode_2d(&maps.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, p.N, p.K, BN, kBK,
                              CU_TENSOR_MAP_SWIZZLE_128B))
    return e;
  // the copy engine stores rows of 16-byte multiples only
  const int tma_out = p.N * static_cast<int>(sizeof(OutT)) % 16 == 0;
  if (tma_out) {
    if (const int e = encode_2d(&maps.out, kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                sizeof(OutT), p.out, p.M, p.N, 16, kOutChunkRow, CU_TENSOR_MAP_SWIZZLE_64B))
      return e;
  } else {
    maps.out = maps.a;  // never read
  }
  static bool sized[kMaxDevices] = {};  // the kernel's shared-memory limit raised on the device
  bool& done = sized[current_device()];
  if (!done) {
    const cudaError_t attr = cudaFuncSetAttribute(int8_gemm_kernel<BN, OutT>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    done = true;
  }
  const long long tiles = static_cast<long long>((p.M + kBM - 1) / kBM) * ((p.N + BN - 1) / BN);
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));  // persistent: a block a SM
  int8_gemm_kernel<BN, OutT><<<grid, kThreads, S::kSmem, stream>>>(p, maps, tma_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch_gemm(const GemmParams& p, const void* a, const void* b, cudaStream_t s) {
  const int sms = sm_count();
  switch (tile_n(p.M, p.N, sms)) {
    case 256: return launch_gemm<256, OutT>(p, a, b, sms, s);
    case 192: return launch_gemm<192, OutT>(p, a, b, sms, s);
    case 128: return launch_gemm<128, OutT>(p, a, b, sms, s);
    default: return launch_gemm<64, OutT>(p, a, b, sms, s);
  }
}

}  // namespace

// x [M, K] (dtype 0 = bf16, 1 = f32) -> q [M, K] int8, scales [M] f32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int int8_quantize_rows(const void* x, int dtype, void* q, float* scales, int M, int K,
                                  void* stream) {
  if (M < 0 || K <= 0 || (dtype != 0 && dtype != 1)) return kErrShape;
  if (M == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<int8_t*>(q);
  // 16-byte loads where every row starts 16-byte aligned, q's rows then 8 (4)
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                   K % (dtype == 0 ? 8 : 4) == 0;
  if (dtype == 0) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    return vec ? launch_quantize<__nv_bfloat16, 8>(xp, qp, scales, M, K, s)
               : launch_quantize<__nv_bfloat16, 1>(xp, qp, scales, M, K, s);
  }
  const auto* xp = static_cast<const float*>(x);
  return vec ? launch_quantize<float, 4>(xp, qp, scales, M, K, s) : launch_quantize<float, 1>(xp, qp, scales, M, K, s);
}

// a [M, K] int8, b [N, K] int8 (K % 16 == 0, both 16-byte aligned), xs [M],
// ks [N], bias [N] or null, all f32 -> out [M, N] (out_dtype 0 = bf16,
// 1 = f32). Returns cudaGetLastError() after the launch (0 = launched) or
// an error of the tensor maps (int8_matmul_error names each).
extern "C" int int8_gemm(const void* a, const void* b, const float* xs, const float* ks,
                         const float* bias, void* out, int out_dtype, int M, int N, int K,
                         void* stream) {
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 || (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return kErrShape;
  if (M == 0 || N == 0) return 0;
  const GemmParams p{xs, ks, bias, out, M, N, K};
  auto s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? dispatch_gemm<__nv_bfloat16>(p, a, b, s) : dispatch_gemm<float>(p, a, b, s);
}

// The tile width N of int8_gemm's launch rule at M x N on the current card
// (the tiles are 128 x N).
extern "C" int int8_gemm_tile_n(int M, int N) {
  return tile_n(M, N, sm_count());
}

extern "C" const char* int8_matmul_error(int code) {
  if (code == kErrShape)
    return "int8_matmul: a shape, type or alignment the kernels do not take (K % 16, 16-byte operands)";
  if (code == kErrNoEncoder) return "cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled";
  if (code >= kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (the code minus 20000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
