// CTC forward-backward for Hopper, sm_90a: the alpha and beta recursions
// (the forward runs both in one launch) and the gradient with respect to the
// logits (the backward).
//
// Replaces no Pallas kernel. w2v2_speaker_tpu/objectives/losses.py::ctc_loss
// (:176-204) computes CTC with optax.ctc_loss, which XLA compiles. The port
// first called F.ctc_loss, whose CUDA backward sums with atomics and has no
// deterministic implementation; these kernels sum every output in a fixed
// order, so two launches on the same inputs are bit-equal and
// trainer.deterministic=true trains the CTC recipes on the card.
//
// Function (w2v2_speaker_tpu_torch/ops/ctc.py holds the plain versions, with
// the same split, in log space: logsumexp in float64, held against these
// kernels at its kernel_tolerance). Per row b: lp
// [T, V] float32 log-softmax, T_b frames (clamped to T), a label of L_b
// tokens (clamped to S), the extended label l' of S'_b = 2 L_b + 1 states
// (blank, l_1, blank, ..., l_L, blank), p_t(v) = exp(lp[t, v]):
// - alpha: alpha_0(0) = p_0(blank), alpha_0(1) = p_0(l'_1); for t < T_b,
//   alpha_t(s) = ((alpha_{t-1}(s) + alpha_{t-1}(s-1)) + alpha_{t-1}(s-2))
//   p_t(l'_s), the last term only where l'_s is not blank and differs from
//   l'_{s-2}; logp_b = log(alpha_{T_b-1}(S'_b-1) + alpha_{T_b-1}(S'_b-2))
//   (-inf: no path fits; a row of no frames and no label: 0).
// - beta: beta_{T_b-1}(s) = 1 at S'_b-1 and S'_b-2, 0 elsewhere; beta_t(s) =
//   (beta_{t+1}(s) p_{t+1}(l'_s) + beta_{t+1}(s+1) p_{t+1}(l'_{s+1})) +
//   beta_{t+1}(s+2) p_{t+1}(l'_{s+2}) (the skip as above, at s+2).
// - the gradient: grad[b, t, v] = g_b (p_t(v) - sum over s with l'_s = v of
//   alpha_t(s) beta_t(s) / P_b), P_b the row's likelihood as alpha summed
//   it, the sum in ascending s: the gradient of g_b x nll_b with respect to
//   the logits whose log-softmax is lp, rounded to float32 once. Frames
//   t >= T_b and rows with P_b = 0 (zero_infinity) get exactly 0.
// alpha and beta are written for t < T_b, s < S'_b only.
//
// Numbers: float64 with an exponent of their own. Each probability is held
// as m 2^k, m a float64 mantissa normalised to [0.5, 1), k an int, so no
// alpha or beta underflows however long the row (a speech row's likelihood
// sums ~1000 frames; the speaker CTC's labels start at e^-100 a frame). A
// sum aligns its terms to the largest exponent (moving the exponent field:
// exact), adds the mantissas in the order above, multiplies by the
// emission's mantissa and normalises (frexp by bit operations). 0 is m =
// 0.5 at k = -2^29: far enough below any value that it cannot change a sum's
// bits, so no branch is needed for it; exponents below -2^28 read as 0.
// exp(lp) is the library's exp (as PyTorch's CUDA exp), split as exp(lp -
// kp ln 2) 2^kp below lp = -700. So the frame chain holds no transcendental
// at all: a frame is ~25 integer and float64 operations a state, where a
// log-space recursion (the first version of these kernels, log-sum-exp in
// float64) spends three exp and one log. The precision is float64's: each
// operation rounds once, ~1e-16 relative, and the only float32 roundings
// are lp's and the gradient's. (Why not float32: a float32 log-space alpha
// near -100 carries ~1e-5 absolute error into exp(alpha + beta - logp), and
// the blank's gradient, a difference of two numbers near 1, ~1e-5.) alpha and
// beta go out as [..., 2] float64 pairs (m, k).
//
// Launches. The forward is one launch of ctc_chain_kernel over 2B blocks,
// the alpha chain of each row in blocks [0, B) and its beta chain in blocks
// [B, 2B): beta does not depend on alpha, so the two chains of T_b frames run
// side by side on 2B SMs. The backward is one launch of ctc_grad_kernel.
//
// What bounds the chains (H100 SXM: 3.35 TB/s, 34 TFLOP/s float64 outside
// the tensor cores): not bytes (the gathered lp in, alpha and beta out; ~0.04
// ms at 8 x 1199 frames) but the chain of T_b dependent frames a row, on
// one SM: the latency of a frame's dependent operations, and at S' ~ 600
// states the SM's instruction issue. The design:
// - A thread a pair of states. Thread n of a row's N threads (N = S + 1
//   pairs rounded up to whole warps, at most 1024) owns pair i = n (and n +
//   kN, k < P, where S + 1 > 1024 pairs: P = 2, 4 or 8 pair slots, labels of
//   up to 8191 tokens): alpha pairs (blank 2i, label 2i+1), beta pairs
//   (label 2j-1, blank 2j). A pair's two values live in registers. In either
//   direction a pair reads one value of its neighbour pair from the last
//   frame (alpha: alpha(2i-1), the label below; beta: beta(2j+1), the label
//   above): one warp shuffle, and across a warp edge one shared-memory slot a
//   warp and pair slot, double-buffered by frame parity, so one __syncthreads
//   a frame (none for a block of one warp). Consecutive threads own
//   consecutive pairs in every slot, so alpha and beta go out in coalesced
//   16-byte stores, with the streaming hint (__stcs: the backward reads
//   them once, long after).
// - Emissions off the chain. The block fills a table of exp(lp) for a chunk
//   of frames in shared memory (up to 128 frames, 40 KB) in one parallel pass
//   with a barrier either side, then the chain reads its emissions from it:
//   a row of the vocabulary a frame where V <= 2S + 1 (the speech recipes:
//   V = 32 exps a frame for ~600 states), else a row of the states (the
//   speaker CTC: V = 5995, 3 states).
// - The gradient: one block a (row, F frames), 256 threads. The block
//   computes the occupancies alpha beta / P of its frames, one state and
//   frame a thread (a product and an exponent add: no exp), into shared
//   memory, then every thread takes (frame, v) outputs, F = 256 / V frames a
//   block (1 to 8): a label v's occupancy sums the label states with l'_s =
//   v in ascending s (the blank every even state and any odd state whose
//   token is the blank). Rows and frames outside the function write zeros.
//
// No atomics: every alpha, beta and gradient element is written by one
// thread, and each occupancy sum runs over s in one thread in a fixed order.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kChainThreads = 1024;    // a row's block, at most: 1024 x P pairs of states
constexpr int kMaxPairs = 8;           // pairs a thread: labels of up to 8 x 1024 - 1 tokens
constexpr int kChunk = 128;            // frames of emissions a table chunk, at most
constexpr int kTableBytes = 40 * 1024;  // a chunk's table in shared memory, where it fits
constexpr int kGradThreads = 256;      // gradient: one block a (row, F frames)
constexpr int kGradFrames = 8;         // F at most
constexpr int kMaxSmem = 232448;       // the most dynamic shared memory a block may take (227 KB)
constexpr int kErrShape = 10001;       // error codes past the CUDA runtime's
constexpr int kErrLabel = 10002;
constexpr int kZeroExp = -(1 << 29);   // a zero's exponent: m 2^k with k < kZeroLim is 0
constexpr int kZeroLim = -(1 << 28);
constexpr int kLowExp = -(1 << 27);    // exp(lp) below 2^kLowExp is 0
constexpr int kFlush = -1000;          // a term is aligned down by at most 2^-1000
constexpr double kLowLp = -700.0;      // below, exp(lp) is split: exp(-700.7) is still a normal double
constexpr double kLn2 = 0.6931471805599453;
constexpr double kZeroLp = kLowExp * kLn2;
constexpr double kNegInf = -INFINITY;

// A probability m 2^k, m a normal double (in [0.5, 1) once normalised). 0 is
// m = 0.5 with k = kZeroExp: far enough below every other value that it
// never changes a sum's bits, with no branch for it anywhere on the chain.
struct Ext {
  double m;
  int k;
};

__device__ __forceinline__ Ext zero() { return {0.5, kZeroExp}; }

// m 2^max(d, kFlush): the exponent field moves, exactly (m in [2^-3, 3),
// so the result stays normal). d <= 0 aligns a term to the largest of a sum
// (m >= 2^-2 there), and what it loses below 2^-1000 cannot reach the sum's
// last bit.
__device__ __forceinline__ double scale(double m, int d) {
  return __hiloint2double(__double2hiint(m) + max(d, kFlush) * (1 << 20), __double2loint(m));
}

// frexp of a normal x > 0: (f in [0.5, 1), k + e) with x = f 2^e; a zero's
// exponent stays at kZeroExp or above
__device__ __forceinline__ Ext norm(double x, int k) {
  const int hi = __double2hiint(x);
  return {__hiloint2double((hi & 0x800fffff) | 0x3fe00000, __double2loint(x)), max(k + (hi >> 20) - 1022, kZeroExp)};
}

// (a + b) + c aligned to the largest exponent E: (the unnormalised sum, E)
__device__ __forceinline__ Ext sum3(Ext a, Ext b, Ext c) {
  const int E = max(a.k, max(b.k, c.k));
  return {(scale(a.m, a.k - E) + scale(b.m, b.k - E)) + scale(c.m, c.k - E), E};
}

// sum3(a, b, zero()): the same bits
__device__ __forceinline__ Ext sum2(Ext a, Ext b) {
  const int E = max(a.k, b.k);
  return {scale(a.m, a.k - E) + scale(b.m, b.k - E), E};
}

// a p, unnormalised (m in [0.25, 1))
__device__ __forceinline__ Ext mul(Ext a, Ext p) { return {a.m * p.m, a.k + p.k}; }

// exp(lp) as m 2^k: exp(lp) itself down to lp = -700, below it exp(lp -
// kp ln 2) 2^kp, so that no emission underflows; 0 below kZeroLp (and for
// -inf)
__device__ __forceinline__ Ext emission(float lpf) {
  const double lp = lpf;
  if (!(lp >= kZeroLp)) return zero();
  const double kp = lp < kLowLp ? floor((lp - kLowLp) / kLn2) : 0.0;
  return norm(exp(lp - kp * kLn2), static_cast<int>(kp));
}

__device__ __forceinline__ double log_of(Ext x) { return x.k < kZeroLim ? kNegInf : log(x.m) + x.k * kLn2; }

struct Row {
  int T_b, L_b, states;  // frames, tokens, 2 L_b + 1
};

__device__ __forceinline__ Row row_of(const int* in_len, const int* lab_len, int b, int T, int S) {
  Row r;
  r.T_b = min(max(in_len[b], 0), T);
  r.L_b = min(max(lab_len[b], 0), S);
  r.states = 2 * r.L_b + 1;
  return r;
}

__device__ __forceinline__ void frame_barrier() {
  if (blockDim.x > 32) __syncthreads();  // uniform over the block
}

// What a chain block shares: the emission table of a chunk of frames (row f,
// entry j: exp(lp[frame, v = j]) in vocabulary mode, exp(lp[frame, l'_j]) in
// state mode), and each warp's edge value of each pair slot at the last two
// frames.
struct Shared {
  double* tm;  // [C][W] mantissas
  int* tk;     // [C][W] exponents
  int W, C;
  bool vocab;
  double (*edge_m)[kMaxPairs][32];
  int (*edge_k)[kMaxPairs][32];
};

// The table of frames first .. first + n - 1, filled by the whole block.
__device__ void fill(const Shared& sh, const float* __restrict__ lpb, const int* __restrict__ lab, const Row r,
                     int V, int blank, int first, int n) {
  __syncthreads();  // the last chunk's reads are done
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n * sh.W; idx += blockDim.x) {
    const int f = idx / sh.W, j = idx - f * sh.W;
    const int v = sh.vocab ? j : ((j & 1) && j < r.states ? lab[j >> 1] : blank);
    const Ext e = emission(__ldg(lpb + static_cast<long long>(first + f) * V + v));
    sh.tm[idx] = e.m;
    sh.tk[idx] = e.k;
  }
  __syncthreads();
}

__device__ __forceinline__ Ext edge(const Shared& sh, int t, int k, int warp) {
  return {sh.edge_m[t & 1][k][warp], sh.edge_k[t & 1][k][warp]};
}

__device__ __forceinline__ void set_edge(const Shared& sh, int t, int k, int warp, Ext x) {
  sh.edge_m[t & 1][k][warp] = x.m;
  sh.edge_k[t & 1][k][warp] = x.k;
}

// alpha or beta out, streamed (evict first: the backward reads it once, long after)
__device__ __forceinline__ void put(double2* at, Ext x) { __stcs(at, make_double2(x.m, static_cast<double>(x.k))); }

// The alpha chain of one row: thread n of N owns the pairs i = n + kN (pair
// slots k < P), the blank state 2i (a0) and the label state 2i+1 (a1, token
// lab[i]); pair i - 1 is thread n - 1's in the same slot (thread N - 1's in
// slot k - 1 for thread 0).
template <int P>
__device__ void alpha_row(const Shared& sh, const float* __restrict__ lpb, const int* __restrict__ lab, const Row r,
                          double2* __restrict__ ab, double* __restrict__ logp, int V, int Sp, int blank, Ext* fin) {
  const int n = threadIdx.x, N = blockDim.x, lane = n & 31, warp = n >> 5, last = (N >> 5) - 1;
  int jb[P], jl[P];  // table entries of the two states' emissions
  bool blank_ok[P], lab_ok[P], skip[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = n + k * N;
    blank_ok[k] = i <= r.L_b;
    lab_ok[k] = i < r.L_b;
    const int tok = lab_ok[k] ? lab[i] : blank;
    skip[k] = lab_ok[k] && i >= 1 && tok != blank && tok != lab[i - 1];
    jb[k] = sh.vocab ? blank : min(2 * i, sh.W - 1);
    jl[k] = sh.vocab ? tok : min(2 * i + 1, sh.W - 1);
  }
  double2* at = ab + 2 * n;  // the thread's slot 0 at frame t
  auto store = [&](const Ext* a0, const Ext* a1) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (blank_ok[k]) put(at + 2 * k * N, a0[k]);
      if (lab_ok[k]) put(at + 2 * k * N + 1, a1[k]);
    }
  };
  int first = 0;
  fill(sh, lpb, lab, r, V, blank, 0, min(sh.C, r.T_b));
  Ext a0[P], a1[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    a0[k] = n + k == 0 ? Ext{sh.tm[jb[k]], sh.tk[jb[k]]} : zero();
    a1[k] = n + k == 0 && lab_ok[k] ? Ext{sh.tm[jl[k]], sh.tk[jl[k]]} : zero();
    if (lane == 31) set_edge(sh, 0, k, warp, a1[k]);
  }
  store(a0, a1);
  frame_barrier();
  const double* tm = sh.tm;  // the table's row of frame t
  const int* tk = sh.tk;
  for (int t = 1; t < r.T_b; ++t) {
    at += Sp;
    tm += sh.W;
    tk += sh.W;
    if (t - first == sh.C) {  // uniform over the block
      first = t;
      fill(sh, lpb, lab, r, V, blank, first, min(sh.C, r.T_b - first));
      tm = sh.tm;
      tk = sh.tk;
    }
    Ext n0[P], n1[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const Ext pb = {tm[jb[k]], tk[jb[k]]}, pl = {tm[jl[k]], tk[jl[k]]};
      const Ext shuffled = {__shfl_up_sync(0xffffffffu, a1[k].m, 1), __shfl_up_sync(0xffffffffu, a1[k].k, 1)};
      const Ext from_edge = warp > 0 ? edge(sh, t - 1, k, max(warp - 1, 0))
                                     : (k > 0 ? edge(sh, t - 1, k > 0 ? k - 1 : 0, last) : zero());
      const Ext left = lane > 0 ? shuffled : from_edge;  // alpha_{t-1}(2i - 1)
      const Ext sb = sum2(a0[k], left), sl = sum3(a1[k], a0[k], skip[k] ? left : zero());
      n0[k] = blank_ok[k] ? norm(sb.m * pb.m, sb.k + pb.k) : zero();
      n1[k] = lab_ok[k] ? norm(sl.m * pl.m, sl.k + pl.k) : zero();
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      a0[k] = n0[k];
      a1[k] = n1[k];
      if (lane == 31) set_edge(sh, t, k, warp, a1[k]);
    }
    store(a0, a1);
    frame_barrier();
  }
  // logp from alpha_{T_b-1} at S'_b - 1 (the blank of pair L_b) and S'_b - 2
  // (the label of pair L_b - 1)
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (n + k * N == r.L_b) fin[0] = a0[k];
    if (n + k * N == r.L_b - 1) fin[1] = a1[k];
  }
  __syncthreads();
  if (n == 0) {
    const Ext total = sum2(fin[0], r.L_b >= 1 ? fin[1] : zero());
    *logp = log_of(norm(total.m, total.k));
  }
}

// The beta chain of one row: thread n of N owns the pairs j = n + kN, the
// label state 2j-1 (b1, token lab[j-1], j >= 1) and the blank state 2j (b0);
// the label state 2j+1 above a pair is pair j + 1's: thread n + 1's in the
// same slot (thread 0's in slot k + 1 for thread N - 1). Frame t reads the
// emissions of frame t + 1.
template <int P>
__device__ void beta_row(const Shared& sh, const float* __restrict__ lpb, const int* __restrict__ lab, const Row r,
                         double2* __restrict__ bb, int V, int Sp, int blank) {
  const int n = threadIdx.x, N = blockDim.x, lane = n & 31, warp = n >> 5, last = (N >> 5) - 1;
  int jb[P], jl[P], ju[P];  // table entries: the pair's two states, the label state above
  bool blank_ok[P], lab_ok[P], skip[P];  // skip: the transition from 2j-1 to 2j+1
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = n + k * N;
    blank_ok[k] = j <= r.L_b;
    lab_ok[k] = j >= 1 && j <= r.L_b;
    const int tok = lab_ok[k] ? lab[j - 1] : blank;
    skip[k] = lab_ok[k] && j < r.L_b && lab[j] != blank && lab[j] != tok;
    jb[k] = sh.vocab ? blank : min(2 * j, sh.W - 1);
    jl[k] = sh.vocab ? tok : (j >= 1 ? min(2 * j - 1, sh.W - 1) : 0);
    ju[k] = sh.vocab ? (j < r.L_b ? lab[j] : blank) : min(2 * j + 1, sh.W - 1);
  }
  double2* bt = bb + static_cast<long long>(r.T_b - 1) * Sp + 2 * n;  // the thread's slot 0 at frame t
  auto store = [&](const Ext* b0, const Ext* b1) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (lab_ok[k]) put(bt + 2 * k * N - 1, b1[k]);
      if (blank_ok[k]) put(bt + 2 * k * N, b0[k]);
    }
  };
  Ext b0[P], b1[P];
  const Ext one = {0.5, 1};
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool end = n + k * N == r.L_b;
    b0[k] = end ? one : zero();
    b1[k] = end && r.L_b >= 1 ? one : zero();
    if (lane == 0) set_edge(sh, r.T_b - 1, k, warp, b1[k]);
  }
  store(b0, b1);
  frame_barrier();
  int first = r.T_b;  // the table's first frame
  const double* tm = sh.tm;  // the table's row of frame t + 1
  const int* tk = sh.tk;
  for (int t = r.T_b - 2; t >= 0; --t) {
    bt -= Sp;
    tm -= sh.W;
    tk -= sh.W;
    if (t + 1 < first) {  // uniform over the block
      first = max(1, t + 2 - sh.C);
      fill(sh, lpb, lab, r, V, blank, first, t + 2 - first);
      tm = sh.tm + (t + 1 - first) * sh.W;
      tk = sh.tk + (t + 1 - first) * sh.W;
    }
    Ext n0[P], n1[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const Ext pb = {tm[jb[k]], tk[jb[k]]}, pl = {tm[jl[k]], tk[jl[k]]}, pu = {tm[ju[k]], tk[ju[k]]};
      const Ext shuffled = {__shfl_down_sync(0xffffffffu, b1[k].m, 1), __shfl_down_sync(0xffffffffu, b1[k].k, 1)};
      const Ext from_edge = warp < last ? edge(sh, t + 1, k, min(warp + 1, last))
                                        : (k + 1 < P ? edge(sh, t + 1, k + 1 < P ? k + 1 : k, 0) : zero());
      const Ext above = lane < 31 ? shuffled : from_edge;  // beta_{t+1}(2j + 1)
      const Ext e_lab = mul(b1[k], pl), e_blank = mul(b0[k], pb), e_up = mul(above, pu);
      const Ext sl = sum3(e_lab, e_blank, skip[k] ? e_up : zero()), sb = sum2(e_blank, e_up);
      n1[k] = lab_ok[k] ? norm(sl.m, sl.k) : zero();
      n0[k] = blank_ok[k] ? norm(sb.m, sb.k) : zero();
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      b0[k] = n0[k];
      b1[k] = n1[k];
      if (lane == 0) set_edge(sh, t, k, warp, b1[k]);
    }
    store(b0, b1);
    frame_barrier();
  }
}

template <int P>
__global__ void __launch_bounds__(kChainThreads) ctc_chain_kernel(
    const float* __restrict__ lp, const int* __restrict__ labels, const int* __restrict__ in_len,
    const int* __restrict__ lab_len, double2* __restrict__ alpha, double2* __restrict__ beta,
    double* __restrict__ logp, int B, int T, int V, int S, int blank, int W, int C) {
  extern __shared__ double table_m[];  // [C][W] mantissas, then [C][W] exponents
  __shared__ double edge_m[2][kMaxPairs][32];
  __shared__ int edge_k[2][kMaxPairs][32];
  __shared__ Ext fin[2];
  const bool backward = blockIdx.x >= B;
  const int b = backward ? blockIdx.x - B : blockIdx.x;
  const Row r = row_of(in_len, lab_len, b, T, S);
  const int Sp = 2 * S + 1;
  if (r.T_b == 0) {  // uniform over the block, before any barrier
    if (!backward && threadIdx.x == 0) logp[b] = r.L_b == 0 ? 0.0 : kNegInf;
    return;
  }
  const Shared sh = {table_m, reinterpret_cast<int*>(table_m + C * W), W, C, W == V, edge_m, edge_k};
  const float* lpb = lp + static_cast<long long>(b) * T * V;
  const int* lab = labels + static_cast<long long>(b) * S;
  const long long row = static_cast<long long>(b) * T * Sp;
  if (backward)
    beta_row<P>(sh, lpb, lab, r, beta + row, V, Sp, blank);
  else
    alpha_row<P>(sh, lpb, lab, r, alpha + row, logp + b, V, Sp, blank, fin);
}

__global__ void __launch_bounds__(kGradThreads) ctc_grad_kernel(
    const float* __restrict__ lp, const int* __restrict__ labels, const int* __restrict__ in_len,
    const int* __restrict__ lab_len, const double2* __restrict__ alpha, const double2* __restrict__ beta,
    const double* __restrict__ logp, const double* __restrict__ g, float* __restrict__ grad, int T, int V, int S,
    int blank, int F) {
  extern __shared__ double smem[];
  const int Sp = 2 * S + 1;
  double* gamma = smem;                              // [F][Sp] occupancies
  int* lab = reinterpret_cast<int*>(smem + F * Sp);  // the row's tokens
  const int t0 = blockIdx.x * F, b = blockIdx.y;
  const Row r = row_of(in_len, lab_len, b, T, S);
  const int nf = min(F, T - t0);
  const long long cell0 = static_cast<long long>(b) * T + t0;
  float* out = grad + cell0 * V;
  const int live = logp[b] == kNegInf ? 0 : max(0, min(nf, r.T_b - t0));  // the block's frames inside the row
  if (live == 0) {  // uniform over the block, before any barrier
    for (int idx = threadIdx.x; idx < nf * V; idx += blockDim.x) out[idx] = 0.f;
    return;
  }
  // the row's likelihood as the forward summed it: alpha_{T_b-1} at S'_b - 1 and S'_b - 2
  const double2* last = alpha + (static_cast<long long>(b) * T + r.T_b - 1) * Sp;
  const double2 x = last[r.states - 1], y = r.L_b >= 1 ? last[r.states - 2] : make_double2(0.5, kZeroExp);
  const Ext total = sum2({x.x, static_cast<int>(x.y)}, {y.x, static_cast<int>(y.y)});
  const double inv = 1.0 / total.m;
  for (int i = threadIdx.x; i < r.L_b; i += blockDim.x) lab[i] = labels[static_cast<long long>(b) * S + i];
  for (int idx = threadIdx.x; idx < live * r.states; idx += blockDim.x) {
    const int f = idx / r.states, s = idx - f * r.states;
    const long long at = (cell0 + f) * Sp + s;
    const double2 a = alpha[at], c = beta[at];
    const int d = static_cast<int>(a.y) + static_cast<int>(c.y) - total.k;  // a zero's is below kFlush
    gamma[f * Sp + s] = d >= kFlush ? scale((a.x * c.x) * inv, d) : 0.0;
  }
  __syncthreads();
  const double gb = g[b];
  const float* lpt = lp + cell0 * V;
  for (int idx = threadIdx.x; idx < nf * V; idx += blockDim.x) {
    const int f = idx / V, v = idx - f * V;
    if (f >= live) {
      out[idx] = 0.f;
      continue;
    }
    const double* gm = gamma + f * Sp;
    double occ = 0.0;
    if (v == blank) {
      for (int s = 0; s < r.states; ++s)
        if (!(s & 1) || lab[s >> 1] == v) occ += gm[s];
    } else {
      for (int i = 0; i < r.L_b; ++i)
        if (lab[i] == v) occ += gm[2 * i + 1];
    }
    out[idx] = static_cast<float>(gb * (exp(static_cast<double>(lpt[idx])) - occ));
  }
}

int check_shape(int B, int T, int V, int S, int blank) {
  if (B < 0 || T < 0 || V <= 0 || S < 0 || blank < 0 || blank >= V || B > 65535) return kErrShape;
  return 0;
}

// Pairs a thread: the least P (a power of two) that fits S + 1 pairs in
// kChainThreads threads; 0 where even kMaxPairs does not.
int pairs_per_thread(int S) {
  for (int p = 1; p <= kMaxPairs; p *= 2)
    if (S + 1 <= p * kChainThreads) return p;
  return 0;
}

template <int P>
int launch_chain(int blocks, int smem, const float* lp, const int* labels, const int* in_len, const int* lab_len,
                 double2* alpha, double2* beta, double* logp, int B, int T, int V, int S, int blank, int W, int C,
                 cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const auto err = cudaFuncSetAttribute(ctc_chain_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = ((S + 1 + P - 1) / P + 31) / 32 * 32;
  ctc_chain_kernel<P><<<blocks, threads, smem, stream>>>(lp, labels, in_len, lab_len, alpha, beta, logp, B, T, V, S,
                                                         blank, W, C);
  return static_cast<int>(cudaGetLastError());
}

// Frames a gradient block: 256 / V in [1, kGradFrames], halved while the
// occupancies and the tokens exceed the shared memory; 0 where one frame does.
int grad_frames(int V, int S, long long* smem) {
  for (int F = std::min(kGradFrames, std::max(1, kGradThreads / V)); F >= 1; F /= 2) {
    *smem = 8LL * F * (2LL * S + 1) + 4LL * S;
    if (*smem <= kMaxSmem) return F;
  }
  return 0;
}

}  // namespace

// lp [B, T, V] float32, labels [B, S] int32 (0-padded), in_len [B] and
// lab_len [B] int32 -> alpha and beta [B, T, 2S+1, 2] float64 (m, k: alpha =
// m 2^k; each written at its row's frames and states) and logp [B] float64,
// in one launch. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ctc_forward(const float* lp, const int* labels, const int* in_len, const int* lab_len, double* alpha,
                           double* beta, double* logp, int B, int T, int V, int S, int blank, void* stream) {
  if (int err = check_shape(B, T, V, S, blank)) return err;
  const int P = pairs_per_thread(S);
  if (P == 0) return kErrLabel;
  // the emission table: a row of the vocabulary a frame where V <= 2S+1,
  // else a row of the states; as many frames as fit kTableBytes
  const int W = std::min(V, 2 * S + 1);
  const int C = std::max(1, std::min({kChunk, std::max(T, 1), kTableBytes / (12 * W)}));
  const long long smem = 12LL * C * W;
  if (smem > kMaxSmem - 1024) return kErrLabel;
  if (B == 0) return 0;
  const int blocks = 2 * B;
  auto a = reinterpret_cast<double2*>(alpha);
  auto bt = reinterpret_cast<double2*>(beta);
  auto s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(smem);
  switch (P) {
    case 1: return launch_chain<1>(blocks, m, lp, labels, in_len, lab_len, a, bt, logp, B, T, V, S, blank, W, C, s);
    case 2: return launch_chain<2>(blocks, m, lp, labels, in_len, lab_len, a, bt, logp, B, T, V, S, blank, W, C, s);
    case 4: return launch_chain<4>(blocks, m, lp, labels, in_len, lab_len, a, bt, logp, B, T, V, S, blank, W, C, s);
    default: return launch_chain<8>(blocks, m, lp, labels, in_len, lab_len, a, bt, logp, B, T, V, S, blank, W, C, s);
  }
}

// The backward: grad [B, T, V] float32 from lp, alpha, beta (as ctc_forward
// writes them), logp [B] and the upstream g [B] (float64). One launch on the
// stream; returns its error (0 = launched).
extern "C" int ctc_grad(const float* lp, const int* labels, const int* in_len, const int* lab_len,
                        const double* alpha, const double* beta, const double* logp, const double* g, float* grad,
                        int B, int T, int V, int S, int blank, void* stream) {
  if (int err = check_shape(B, T, V, S, blank)) return err;
  long long smem = 0;
  const int F = grad_frames(V, S, &smem);
  if (F == 0) return kErrLabel;
  if (B == 0 || T == 0) return 0;
  if (smem > 48 * 1024) {
    const auto err = cudaFuncSetAttribute(ctc_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ctc_grad_kernel<<<dim3((T + F - 1) / F, B), kGradThreads, static_cast<int>(smem),
                    static_cast<cudaStream_t>(stream)>>>(lp, labels, in_len, lab_len,
                                                         reinterpret_cast<const double2*>(alpha),
                                                         reinterpret_cast<const double2*>(beta), logp, g, grad, T, V,
                                                         S, blank, F);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ctc_loss_error(int code) {
  if (code == kErrShape) return "ctc_loss: a shape the kernels do not take (V >= 1, 0 <= blank < V, B <= 65535)";
  if (code == kErrLabel) return "ctc_loss: labels too long (at most 8191 tokens, and 2S+1 float64 states in shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
