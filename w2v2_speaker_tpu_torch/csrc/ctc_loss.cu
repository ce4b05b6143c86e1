// CTC forward-backward for Hopper, sm_90a: the alpha recursion (forward), the
// beta recursion and the gradient with respect to the logits (backward).
//
// Replaces no Pallas kernel. w2v2_speaker_tpu/objectives/losses.py::ctc_loss
// (:176-204) computes CTC with optax.ctc_loss, which XLA compiles. The port
// first called F.ctc_loss, whose CUDA backward sums with atomics and has no
// deterministic implementation; these kernels sum every output in a fixed
// order, so two launches on the same inputs are bit-equal and
// trainer.deterministic=true trains the CTC recipes on the card.
//
// Function (w2v2_speaker_tpu_torch/ops/ctc.py holds the plain versions, in
// the same order of operations). Per row b: lp [T, V] float32 log-softmax,
// T_b frames (clamped to T), a label of L_b tokens (clamped to S), the
// extended label l' of S'_b = 2 L_b + 1 states (blank, l_1, blank, ..., l_L,
// blank); alpha, beta, logp and the occupancies in float64:
// - ctc_alpha: alpha_0(0) = lp[0, blank], alpha_0(1) = lp[0, l'_1]; for
//   t < T_b, alpha_t(s) = lp[t, l'_s] + lse3(alpha_{t-1}(s), alpha_{t-1}(s-1),
//   alpha_{t-1}(s-2)), the last only where l'_s is not blank and differs from
//   l'_{s-2}; logp_b = logaddexp(alpha_{T_b-1}(S'_b-1), alpha_{T_b-1}(S'_b-2))
//   (-inf: no path fits; a row of no frames and no label: 0). alpha is written
//   for t < T_b, s < S'_b only.
// - ctc_grad: beta_{T_b-1}(s) = 0 at S'_b-1 and S'_b-2, -inf elsewhere;
//   beta_t(s) = lse3(beta_{t+1}(s) + lp[t+1, l'_s], beta_{t+1}(s+1) +
//   lp[t+1, l'_{s+1}], beta_{t+1}(s+2) + lp[t+1, l'_{s+2}]) (the skip as
//   above); then grad[b, t, v] = g_b (exp(lp[t, v]) - sum over s with l'_s = v
//   of exp(alpha_t(s) + beta_t(s) - logp_b)), the sum in ascending s: the
//   gradient of g_b x nll_b with respect to the logits whose log-softmax is
//   lp. Frames t >= T_b and rows with logp_b = -inf (zero_infinity) get 0.
// lse3(a, b, c) = m + log((exp(a - m) + exp(b - m)) + exp(c - m)) with
// m = max (-inf where all are); logaddexp(x, y) = m + log1p(exp(-|x - y|))
// as PyTorch's; the gradient is rounded to float32 once. No
// --use_fast_math: exp, log and log1p are the library functions PyTorch's
// CUDA exp, log and log1p call.
//
// Why float64: a row's log-probabilities reach -100 and below (the speaker
// CTC's blank starts at a bias of 100, and a speech row's likelihood sums
// ~1000 frames), where a float32 holds alpha and beta to ~1e-5 absolute.
// exp(alpha + beta - logp) then carries ~1e-5 relative error, and the
// blank's gradient, the difference of two numbers near 1, ~1e-5 absolute:
// as far from the truth as float32 optax or F.ctc_loss, and in another
// direction. In float64 the kernel's only float32 rounding is lp's and the
// gradient's.
//
// No atomics: every alpha, beta and gradient element is written by one
// thread, and each occupancy sum runs over s in one thread in a fixed order.
//
// Bound (H100 SXM: 3.35 TB/s, 34 TFLOP/s float64 outside the tensor cores):
// the bytes are the gathered lp[t, l'_s] and alpha out (forward), lp, alpha
// and the gradient [B, T, V] (backward); the operations ~10 a state and
// frame (three exp, one log, the adds and compares) and, in the gradient,
// one exp a (t, v) and one add a state and frame. Both are small next to
// the chain: each row's T_b frames depend on each other, one block barrier
// and one dependent shared-memory round trip with an exp/log chain each,
// so a row costs ~T_b x (a few hundred cycles) however wide the card.
//
// Design (correct and simple first):
// - ctc_alpha and the beta pass: one block a row, 256 threads over the
//   states (each thread loops where S'_b is wider than the block), the
//   extended label and the alpha (beta) of two frames double-buffered in
//   dynamic shared memory (20 S' bytes), one __syncthreads a frame. Each
//   frame's values go to global memory for the gradient.
// - The gradient: one block a (frame, row), 128 threads. The block loads the
//   state occupancies exp(alpha + beta - logp) of its frame into shared
//   memory, then each thread takes vocabulary entries v and sums the states
//   with l'_s = v in ascending s. Rows and frames outside the function write
//   zeros and return before any barrier (the branch is uniform over the
//   block).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRowThreads = 256;   // alpha / beta: one block a row
constexpr int kGradThreads = 128;  // gradient: one block a (frame, row)
constexpr int kMaxSmem = 232448;   // the most dynamic shared memory a block may take (227 KB)
constexpr int kErrShape = 10001;   // error codes past the CUDA runtime's
constexpr int kErrLabel = 10002;
constexpr double kNegInf = -INFINITY;

__device__ __forceinline__ double lse3(double a, double b, double c) {
  const double m = fmax(a, fmax(b, c));
  if (m == kNegInf) return kNegInf;
  return m + log(exp(a - m) + exp(b - m) + exp(c - m));
}

__device__ __forceinline__ double logaddexp(double x, double y) {
  if (x == kNegInf && y == kNegInf) return kNegInf;
  return fmax(x, y) + log1p(exp(-fabs(x - y)));
}

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

// The extended label of row b into ext[0, states).
__device__ __forceinline__ void load_extended(int* ext, const int* labels, int b, int S, int states, int blank) {
  for (int s = threadIdx.x; s < states; s += blockDim.x)
    ext[s] = (s & 1) ? labels[static_cast<long long>(b) * S + (s >> 1)] : blank;
}

__global__ void __launch_bounds__(kRowThreads) ctc_alpha_kernel(
    const float* __restrict__ lp, const int* __restrict__ labels, const int* __restrict__ in_len,
    const int* __restrict__ lab_len, double* __restrict__ alpha, double* __restrict__ logp, int T, int V, int S,
    int blank) {
  extern __shared__ double smem[];  // doubles first (8-byte aligned), then the extended label
  const int Sp = 2 * S + 1;
  double* buf = smem;  // two frames of Sp
  int* ext = reinterpret_cast<int*>(smem + 2 * Sp);
  const int b = blockIdx.x;
  const Row r = row_of(in_len, lab_len, b, T, S);
  load_extended(ext, labels, b, S, r.states, blank);
  __syncthreads();
  if (r.T_b == 0) {
    if (threadIdx.x == 0) logp[b] = r.L_b == 0 ? 0.0 : kNegInf;
    return;
  }
  const float* lpb = lp + static_cast<long long>(b) * T * V;
  double* ab = alpha + static_cast<long long>(b) * T * Sp;
  for (int s = threadIdx.x; s < r.states; s += blockDim.x) {
    const double a = s < 2 ? static_cast<double>(lpb[ext[s]]) : kNegInf;
    buf[s] = a;
    ab[s] = a;
  }
  __syncthreads();
  int cur = 0;
  for (int t = 1; t < r.T_b; ++t) {
    const double* prev = buf + cur * Sp;
    double* next = buf + (cur ^ 1) * Sp;
    const float* lpt = lpb + static_cast<long long>(t) * V;
    double* at = ab + static_cast<long long>(t) * Sp;
    for (int s = threadIdx.x; s < r.states; s += blockDim.x) {
      const int l = ext[s];
      const double a1 = s >= 1 ? prev[s - 1] : kNegInf;
      const double a2 = (s >= 2 && l != blank && l != ext[s - 2]) ? prev[s - 2] : kNegInf;
      const double a = lse3(prev[s], a1, a2) + static_cast<double>(lpt[l]);
      next[s] = a;
      at[s] = a;
    }
    __syncthreads();
    cur ^= 1;
  }
  if (threadIdx.x == 0) {
    const double* last = buf + cur * Sp;
    logp[b] = logaddexp(last[r.states - 1], r.states >= 2 ? last[r.states - 2] : kNegInf);
  }
}

__global__ void __launch_bounds__(kRowThreads) ctc_beta_kernel(
    const float* __restrict__ lp, const int* __restrict__ labels, const int* __restrict__ in_len,
    const int* __restrict__ lab_len, double* __restrict__ beta, int T, int V, int S, int blank) {
  extern __shared__ double smem[];
  const int Sp = 2 * S + 1;
  double* buf = smem;
  int* ext = reinterpret_cast<int*>(smem + 2 * Sp);
  const int b = blockIdx.x;
  const Row r = row_of(in_len, lab_len, b, T, S);
  if (r.T_b == 0) return;  // uniform over the block, before any barrier
  load_extended(ext, labels, b, S, r.states, blank);
  const float* lpb = lp + static_cast<long long>(b) * T * V;
  double* bb = beta + static_cast<long long>(b) * T * Sp;
  for (int s = threadIdx.x; s < r.states; s += blockDim.x) {
    const double v = s >= r.states - 2 ? 0.0 : kNegInf;
    buf[s] = v;
    bb[static_cast<long long>(r.T_b - 1) * Sp + s] = v;
  }
  __syncthreads();
  int cur = 0;
  for (int t = r.T_b - 2; t >= 0; --t) {
    const double* prev = buf + cur * Sp;  // beta_{t+1}
    double* next = buf + (cur ^ 1) * Sp;
    const float* lpn = lpb + static_cast<long long>(t + 1) * V;
    double* bt = bb + static_cast<long long>(t) * Sp;
    for (int s = threadIdx.x; s < r.states; s += blockDim.x) {
      const int l = ext[s];
      const double e0 = prev[s] + static_cast<double>(lpn[l]);
      const double e1 = s + 1 < r.states ? prev[s + 1] + static_cast<double>(lpn[ext[s + 1]]) : kNegInf;
      double e2 = kNegInf;
      if (s + 2 < r.states) {
        const int l2 = ext[s + 2];
        if (l2 != blank && l2 != l) e2 = prev[s + 2] + static_cast<double>(lpn[l2]);
      }
      const double v = lse3(e0, e1, e2);
      next[s] = v;
      bt[s] = v;
    }
    __syncthreads();
    cur ^= 1;
  }
}

__global__ void __launch_bounds__(kGradThreads) ctc_grad_kernel(
    const float* __restrict__ lp, const int* __restrict__ labels, const int* __restrict__ in_len,
    const int* __restrict__ lab_len, const double* __restrict__ alpha, const double* __restrict__ beta,
    const double* __restrict__ logp, const double* __restrict__ g, float* __restrict__ grad, int T, int V, int S,
    int blank) {
  extern __shared__ double smem[];
  const int Sp = 2 * S + 1;
  double* gamma = smem;
  int* ext = reinterpret_cast<int*>(smem + Sp);
  const int t = blockIdx.x, b = blockIdx.y;
  const Row r = row_of(in_len, lab_len, b, T, S);
  const double lpr = logp[b];
  const long long cell = static_cast<long long>(b) * T + t;
  float* out = grad + cell * V;
  if (t >= r.T_b || lpr == kNegInf) {  // uniform over the block, before any barrier
    for (int v = threadIdx.x; v < V; v += blockDim.x) out[v] = 0.f;
    return;
  }
  const double* at = alpha + cell * Sp;
  const double* bt = beta + cell * Sp;
  load_extended(ext, labels, b, S, r.states, blank);
  for (int s = threadIdx.x; s < r.states; s += blockDim.x) gamma[s] = exp(at[s] + bt[s] - lpr);
  __syncthreads();
  const double gb = g[b];
  const float* lpt = lp + cell * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    double occ = 0.0;
    for (int s = 0; s < r.states; ++s)
      if (ext[s] == v) occ += gamma[s];
    out[v] = static_cast<float>(gb * (exp(static_cast<double>(lpt[v])) - occ));
  }
}

int check_shape(int B, int T, int V, int S, int blank, long long smem) {
  if (B < 0 || T < 0 || V <= 0 || S < 0 || blank < 0 || blank >= V || B > 65535) return kErrShape;
  if (smem > kMaxSmem) return kErrLabel;
  return 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// Shared bytes of a row kernel (two frames of doubles and the label) and of
// the gradient kernel (a frame's occupancies and the label).
long long row_smem(int S) { return (2LL * 8 + 4) * (2LL * S + 1); }
long long grad_smem(int S) { return (8LL + 4) * (2LL * S + 1); }

}  // namespace

// lp [B, T, V] float32, labels [B, S] int32 (0-padded), in_len [B] and
// lab_len [B] int32 -> alpha [B, T, 2S+1] float64 (each row's frames and
// states) and logp [B] float64. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int ctc_alpha(const float* lp, const int* labels, const int* in_len, const int* lab_len, double* alpha,
                         double* logp, int B, int T, int V, int S, int blank, void* stream) {
  if (int err = check_shape(B, T, V, S, blank, row_smem(S))) return err;
  if (B == 0) return 0;
  const int smem = static_cast<int>(row_smem(S));
  if (int err = set_smem(ctc_alpha_kernel, smem)) return err;
  ctc_alpha_kernel<<<B, kRowThreads, smem, static_cast<cudaStream_t>(stream)>>>(lp, labels, in_len, lab_len, alpha,
                                                                                 logp, T, V, S, blank);
  return static_cast<int>(cudaGetLastError());
}

// The backward: beta [B, T, 2S+1] float64 (scratch) from lp, then grad
// [B, T, V] float32 from lp, alpha, logp [B] and the upstream g [B] (float64).
// Two launches on the stream; returns the first error of either (0 = both
// launched).
extern "C" int ctc_grad(const float* lp, const int* labels, const int* in_len, const int* lab_len,
                        const double* alpha, const double* logp, const double* g, double* beta, float* grad, int B,
                        int T, int V, int S, int blank, void* stream) {
  if (int err = check_shape(B, T, V, S, blank, row_smem(S))) return err;
  if (B == 0 || T == 0) return 0;
  const int smem_row = static_cast<int>(row_smem(S)), smem_grad = static_cast<int>(grad_smem(S));
  if (int err = set_smem(ctc_beta_kernel, smem_row)) return err;
  if (int err = set_smem(ctc_grad_kernel, smem_grad)) return err;
  auto s = static_cast<cudaStream_t>(stream);
  ctc_beta_kernel<<<B, kRowThreads, smem_row, s>>>(lp, labels, in_len, lab_len, beta, T, V, S, blank);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  ctc_grad_kernel<<<dim3(T, B), kGradThreads, smem_grad, s>>>(lp, labels, in_len, lab_len, alpha, beta, logp, g,
                                                             grad, T, V, S, blank);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ctc_loss_error(int code) {
  if (code == kErrShape) return "ctc_loss: a shape the kernels do not take (V >= 1, 0 <= blank < V, B <= 65535)";
  if (code == kErrLabel) return "ctc_loss: labels too long for shared memory (2S+1 states, 20 bytes each)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
