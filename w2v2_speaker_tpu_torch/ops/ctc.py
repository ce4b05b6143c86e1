"""CTC forward-backward: the port's hand-written Hopper kernels, their plain
PyTorch versions and the autograd function.

Replaces no Pallas kernel. ``w2v2_speaker_tpu/objectives/losses.py::
ctc_loss`` (:176-204) computes CTC with ``optax.ctc_loss`` (XLA). The port
first used ``F.ctc_loss``, whose CUDA backward sums with atomics and has no
deterministic implementation, so ``trainer.deterministic=true`` could not
train a CTC recipe on the card. The kernels of ``csrc/ctc_loss.cu`` sum
every output in a fixed order: two launches on the same inputs are
bit-equal, with or without ``trainer.deterministic``.

The function, per row b of float32 logits ``[B, T, V]`` with ``T_b``
frames (``logit_lengths``, clamped to T) and a 0-padded label ``[B, S]`` of
``L_b`` tokens (``label_lengths``, clamped to S), over the extended label
l' (blanks around and between the tokens, S'_b = 2 L_b + 1 states) and
``lp = log_softmax(logits)``:

- alpha: alpha_t(s), the probability of frames 0..t ending in state s:
  alpha_0(0) = p_0(blank), alpha_0(1) = p_0(l'_1), alpha_t(s) =
  ((alpha_{t-1}(s) + alpha_{t-1}(s-1)) + alpha_{t-1}(s-2)) p_t(l'_s) with
  p_t(v) = exp(lp[t, v]), the last term only where l'_s is not the blank
  and differs from l'_{s-2}; the row's log-likelihood ``logp`` =
  log(alpha_{T_b-1}(S'_b-1) + alpha_{T_b-1}(S'_b-2)) (0 for a row of no
  frames and no label, -inf where no path fits);
- beta: beta_t(s), the probability of frames t+1..T_b-1 from state s at
  t, by the same recursion backwards from beta_{T_b-1} = 1 at S'_b-1 and
  S'_b-2;
- the gradient of ``g_b`` x (the row's negative log-likelihood) with
  respect to the logits, g_b (softmax(t, v) - sum over s with l'_s = v of
  alpha_t(s) beta_t(s) / P), P the row's likelihood, the sum in ascending
  s. Frames past T_b and rows where no path fits (``zero_infinity``) get
  exactly 0.

The kernels hold alpha and beta as float64 with an exponent of their own:
m 2^k, m a float64 mantissa in [0.5, 1), k an integer, passed from the
forward to the backward as [..., 2] float64 pairs (``log_space`` reads them
as log alpha). No value underflows however long the row (a speech row's
likelihood sums ~1000 frames, the speaker CTC's labels start at e^-100 a
frame); a sum aligns its terms to the largest exponent, adds the mantissas,
multiplies by the emission and renormalises, each operation rounding once
in float64, and no exp or log runs on the frame chain. The plain versions
run the same recursions in log space (logsumexp in float64, from float64
log-probabilities), split as the kernels are. Both round to float64 at
every step, so they agree to ~1e-15 relative, far inside
``kernel_tolerance``. The gradient is float32, rounded once. (A float32
log-space recursion holds alpha and beta near -100 to ~1e-5 absolute, and
the blank's gradient, a difference of two numbers near 1, would carry that
as ~1e-5 absolute error: as far from the truth as float32 optax or
``F.ctc_loss``, in another direction; ``csrc/ctc_loss.cu``.)

``CTCLossFunction`` (``ctc_loss_rows``) gives each row's loss, -logp, or 0
where no path fits, as ``F.ctc_loss(..., reduction="none",
zero_infinity=True)`` does. Its forward is ``ctc_alpha_beta``, one launch
of the chain kernel that runs each row's alpha chain and beta chain side
by side (beta does not depend on alpha); its backward is ``ctc_grad``, one
launch of the gradient kernel. In the chain kernel a thread owns a pair of
states (alpha: a blank and the label above it; beta: a label and the blank
above it) in registers, reads its neighbour pair's value of the last frame
by a warp shuffle (a shared-memory slot across a warp edge, one barrier a
frame), and reads its emissions from a table of exp(lp) that the block
fills for a chunk of frames at a time, off the chain. Each wrapper counts
its launches (``ctc_alpha_beta.launches``, ``ctc_grad.launches``); on a
CUDA tensor it launches its kernel or raises, on a CPU tensor it runs the
plain versions, ``ctc_alpha_reference``, ``ctc_beta_reference`` and
``ctc_grad_reference``, whose recursions loop over T vectorised over B and
S', with the backward written out from alpha and beta (not autograd
through the loop); ``F.ctc_loss`` runs on neither route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..device import DeviceError

__all__ = [
    "CTCLossFunction",
    "ctc_alpha_beta",
    "ctc_alpha_reference",
    "ctc_beta_reference",
    "ctc_grad",
    "ctc_grad_reference",
    "ctc_loss_rows",
    "kernel_tolerance",
    "log_space",
]

NEG_INF = float("-inf")
LN2 = math.log(2.0)
ZERO_LIM = -(1 << 28)  # the kernels' m 2^k with k below this is 0 (csrc/ctc_loss.cu)
_lib = None


def kernel_tolerance() -> Tuple[float, float]:
    """``(loss rtol, gradient atol)`` of the kernels against the plain
    versions on feasible rows: 1e-5 relative on the loss and 1e-6
    absolute on the logit gradient (each gradient entry lies in [-1, 1]),
    the limits the CPU tests hold the plain version to against optax and
    ``F.ctc_loss``. Both run the recursions in float64, the kernels on
    mantissas and exponents, the plain versions in log space; they differ
    by ~1e-15 relative, far below either limit."""
    return 1e-5, 1e-6


def _lengths(logit_lengths, label_lengths, t: int, s: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    tb = logit_lengths.to(device=device, dtype=torch.int64).clamp(0, t)
    lb = label_lengths.to(device=device, dtype=torch.int64).clamp(0, s)
    return tb, lb


def _extended(labels: torch.Tensor, lb: torch.Tensor, blank: int) -> Tuple[torch.Tensor, ...]:
    """(l' [B, S'], the states of each row [B, S'] (s < 2 L_b + 1), the
    skip transitions [B, S'] (s >= 2, l'_s not blank, l'_s != l'_{s-2}))."""
    b, s = labels.shape
    ext = torch.full((b, 2 * s + 1), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels.to(torch.int64)
    pos = torch.arange(2 * s + 1, device=labels.device)
    states = pos[None, :] < (2 * lb + 1)[:, None]
    skip = torch.zeros_like(states)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    return ext, states, skip


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """logsumexp of three, -inf where all three are: m + log((exp(a - m) +
    exp(b - m)) + exp(c - m)), the kernels' order of the sum."""
    m = torch.maximum(a, torch.maximum(b, c))
    m0 = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    return m0 + torch.log(torch.exp(a - m0) + torch.exp(b - m0) + torch.exp(c - m0))


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x[..., s - k]`` (k > 0) or ``x[..., s + |k|]`` (k < 0) along the
    last axis, -inf where that falls outside."""
    out = torch.full_like(x, NEG_INF)
    if k > 0:
        out[..., k:] = x[..., :-k]
    else:
        out[..., :k] = x[..., -k:]
    return out


def _emissions(lp, ext) -> torch.Tensor:
    """lp[b, t, l'_s] [B, T, S'] in float64."""
    b, t, _ = lp.shape
    return lp.double().gather(2, ext[:, None, :].expand(b, t, ext.shape[1]))


def log_space(x: torch.Tensor) -> torch.Tensor:
    """log alpha (or beta) [...] float64 of the kernels' [..., 2] (m, k)
    form (alpha = m 2^k), -inf where the value is 0: the plain versions'
    form."""
    m, k = x[..., 0], x[..., 1]
    return torch.where(k < ZERO_LIM, torch.full_like(m, NEG_INF), torch.log(m) + k * LN2)


def ctc_alpha_reference(lp, logit_lengths, labels, label_lengths, blank: int = 0):
    """The plain version of ``ctc_alpha_beta``'s alpha chain: (log alpha
    [B, T, S'] float64, -inf outside each row's states; logp [B]
    float64)."""
    b, t, _ = lp.shape
    tb, lb = _lengths(logit_lengths, label_lengths, t, labels.shape[1], lp.device)
    ext, states, skip = _extended(labels, lb, blank)
    emit = _emissions(lp, ext)
    neg = torch.full_like(emit[:, 0], NEG_INF)
    alpha = torch.full_like(emit, NEG_INF)
    a = torch.where(states & (torch.arange(ext.shape[1], device=lp.device) < 2)[None], emit[:, 0], neg)
    alpha[:, 0] = a
    for i in range(1, t):
        a = torch.where(states, _lse3(a, _shift(a, 1), torch.where(skip, _shift(a, 2), neg)) + emit[:, i], neg)
        alpha[:, i] = a
    rows = torch.arange(b, device=lp.device)
    last = alpha[rows, (tb - 1).clamp_min(0)]  # [B, S']
    end = 2 * lb
    x = last[rows, end]
    y = torch.where(end >= 1, last[rows, (end - 1).clamp_min(0)], torch.full_like(x, NEG_INF))
    logp = torch.logaddexp(x, y)
    logp = torch.where(tb == 0, torch.where(lb == 0, torch.zeros_like(logp), torch.full_like(logp, NEG_INF)), logp)
    return alpha, logp


def ctc_beta_reference(lp, logit_lengths, labels, label_lengths, blank: int = 0):
    """The plain version of ``ctc_alpha_beta``'s beta chain: log beta [B,
    T, S'] float64, -inf outside each row's frames and states."""
    b, t, _ = lp.shape
    tb, lb = _lengths(logit_lengths, label_lengths, t, labels.shape[1], lp.device)
    ext, states, skip = _extended(labels, lb, blank)
    emit = _emissions(lp, ext)
    neg = torch.full_like(emit[:, 0], NEG_INF)
    pos = torch.arange(ext.shape[1], device=lp.device)
    end = (2 * lb)[:, None]
    init = torch.where(states & ((pos[None] == end) | (pos[None] == end - 1)), torch.zeros_like(neg), neg)
    skip_up = torch.zeros_like(skip)  # the skip transition from s to s + 2
    skip_up[:, :-2] = skip[:, 2:]
    beta = torch.full_like(emit, NEG_INF)
    nxt = neg
    for i in range(t - 1, -1, -1):
        if i + 1 < t:
            e = nxt + emit[:, i + 1]
            rec = _lse3(e, _shift(e, -1), torch.where(skip_up, _shift(e, -2), neg))
        else:
            rec = neg
        cur = torch.where((tb == i + 1)[:, None], init, torch.where((i < tb - 1)[:, None], rec, neg))
        nxt = torch.where(states, cur, neg)
        beta[:, i] = nxt
    return beta


def ctc_grad_reference(lp, alpha, beta, logp, g, logit_lengths, labels, label_lengths, blank: int = 0):
    """The plain version of ``ctc_grad``: the gradient [B, T, V] (``lp``'s
    type) of sum_b g_b x nll_b with respect to the logits whose
    log-softmax is ``lp``, from the plain log alpha, log beta and logp:
    each occupancy exp(alpha + beta - logp) in float64, summed in
    ascending s, the gradient rounded once."""
    b, t, v = lp.shape
    tb, lb = _lengths(logit_lengths, label_lengths, t, labels.shape[1], lp.device)
    ext, states, _ = _extended(labels, lb, blank)
    lp64 = lp.double()
    live = torch.isfinite(logp)
    gamma = torch.exp(alpha + beta - torch.where(live, logp, torch.zeros_like(logp))[:, None, None])
    gamma = torch.where(states[:, None, :], gamma, torch.zeros_like(gamma))
    occ = torch.zeros_like(lp64).scatter_add_(2, ext[:, None, :].expand(b, t, ext.shape[1]), gamma)
    grad = (g.double()[:, None, None] * (torch.exp(lp64) - occ)).to(lp.dtype)
    keep = (torch.arange(t, device=lp.device)[None, :] < tb[:, None]) & live[:, None]
    return torch.where(keep[:, :, None], grad, torch.zeros_like(grad))


# ------------------------------------------------------------- the kernels


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("ctc_loss")
        lib.ctc_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ctc_grad.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ctc_forward.restype = lib.ctc_grad.restype = ctypes.c_int
        lib.ctc_loss_error.argtypes = [ctypes.c_int]
        lib.ctc_loss_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise DeviceError(f"{name} launch failed: {_kernels().ctc_loss_error(err).decode()} ({err})")


def _on_card(x: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _int32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def _check_inputs(lp, logit_lengths, labels, label_lengths, name: str) -> None:
    if lp.dim() != 3 or lp.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 log-probabilities [B, T, V], got {lp.dtype} {tuple(lp.shape)}")
    b = lp.shape[0]
    if labels.dim() != 2 or labels.shape[0] != b or logit_lengths.shape != (b,) or label_lengths.shape != (b,):
        raise ValueError(f"{name}: labels [B, S] and lengths [B] for B={b}, got {tuple(labels.shape)}, "
                         f"{tuple(logit_lengths.shape)}, {tuple(label_lengths.shape)}")


def ctc_alpha_beta(lp, logit_lengths, labels, label_lengths, blank: int = 0):
    """The forward: (alpha, beta, logp [B] float64) of log-probabilities
    ``lp`` [B, T, V] float32, for ``ctc_grad``. On a CUDA tensor one
    launch of the chain kernel, the alpha and the beta chain of every row
    side by side (counted in ``ctc_alpha_beta.launches``), alpha and beta
    [B, T, S', 2] float64 (m, k) pairs written only at each row's frames
    and states (``log_space`` gives log alpha); on a CPU tensor
    ``ctc_alpha_reference`` and ``ctc_beta_reference``, log alpha and log
    beta [B, T, S']."""
    _check_inputs(lp, logit_lengths, labels, label_lengths, "ctc_alpha_beta")
    if not _on_card(lp, "ctc_alpha_beta"):
        alpha, logp = ctc_alpha_reference(lp, logit_lengths, labels, label_lengths, blank)
        return alpha, ctc_beta_reference(lp, logit_lengths, labels, label_lengths, blank), logp
    b, t, _ = lp.shape
    s = labels.shape[1]
    lp = lp.contiguous()
    alpha = torch.empty((b, t, 2 * s + 1, 2), dtype=torch.float64, device=lp.device)
    beta = torch.empty_like(alpha)
    logp = torch.empty((b,), dtype=torch.float64, device=lp.device)
    ints = [_int32(x, lp.device) for x in (labels, logit_lengths, label_lengths)]
    with torch.cuda.device(lp.device):
        _check(_kernels().ctc_forward(
            lp.data_ptr(), *(x.data_ptr() for x in ints), alpha.data_ptr(), beta.data_ptr(), logp.data_ptr(),
            b, t, lp.shape[2], s, blank, torch.cuda.current_stream(lp.device).cuda_stream), "ctc_alpha_beta")
    if b:
        ctc_alpha_beta.launches += 1
    return alpha, beta, logp


ctc_alpha_beta.launches = 0


def ctc_grad(lp, alpha, beta, logp, g, logit_lengths, labels, label_lengths, blank: int = 0):
    """The gradient [B, T, V] float32 of sum_b g_b nll_b with respect to the
    logits (``ctc_grad_reference``'s function) from ``ctc_alpha_beta``'s
    outputs on the same device: the gradient kernel on a CUDA tensor
    (counted in ``ctc_grad.launches``), the plain version on a CPU
    tensor."""
    _check_inputs(lp, logit_lengths, labels, label_lengths, "ctc_grad")
    if not _on_card(lp, "ctc_grad"):
        return ctc_grad_reference(lp, alpha, beta, logp, g, logit_lengths, labels, label_lengths, blank)
    b, t, v = lp.shape
    s = labels.shape[1]
    if alpha.shape != (b, t, 2 * s + 1, 2) or beta.shape != alpha.shape or logp.shape != (b,) or g.shape != (b,):
        raise ValueError(f"ctc_grad: alpha and beta [B, T, 2S+1, 2], logp [B] and g [B], got {tuple(alpha.shape)}, "
                         f"{tuple(beta.shape)}, {tuple(logp.shape)}, {tuple(g.shape)}")
    lp = lp.contiguous()
    f64 = [x.to(device=lp.device, dtype=torch.float64).contiguous() for x in (alpha, beta, logp, g)]
    ints = [_int32(x, lp.device) for x in (labels, logit_lengths, label_lengths)]
    grad = torch.empty_like(lp)
    if b:
        with torch.cuda.device(lp.device):
            _check(_kernels().ctc_grad(
                lp.data_ptr(), *(x.data_ptr() for x in ints), *(x.data_ptr() for x in f64), grad.data_ptr(),
                b, t, v, s, blank, torch.cuda.current_stream(lp.device).cuda_stream), "ctc_grad")
        ctc_grad.launches += 1
    return grad


ctc_grad.launches = 0


class CTCLossFunction(torch.autograd.Function):
    """Each row's CTC loss (``zero_infinity``) of float32 ``logits`` [B, T,
    V]: the forward runs ``log_softmax`` and ``ctc_alpha_beta``, the
    backward ``ctc_grad``. No atomics on either."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank):
        lp = F.log_softmax(logits, dim=-1)
        alpha, beta, logp = ctc_alpha_beta(lp, logit_lengths, labels, label_lengths, blank)
        ctx.save_for_backward(lp, alpha, beta, logp, logit_lengths, labels, label_lengths)
        ctx.blank = blank
        ctx.mark_non_differentiable(logit_lengths, labels, label_lengths)
        return torch.where(torch.isfinite(logp), -logp, torch.zeros_like(logp)).to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        lp, alpha, beta, logp, logit_lengths, labels, label_lengths = ctx.saved_tensors
        grad = ctc_grad(lp, alpha, beta, logp, g.contiguous(), logit_lengths, labels, label_lengths, ctx.blank)
        return grad, None, None, None, None


def ctc_loss_rows(logits, logit_lengths, labels, label_lengths, blank: int = 0) -> torch.Tensor:
    """Each row's CTC loss [B] of ``logits`` [B, T, V] (taken in float32):
    ``F.ctc_loss(log_softmax, ..., reduction="none", zero_infinity=True)``'s
    function through ``CTCLossFunction``."""
    return CTCLossFunction.apply(logits.float(), logit_lengths, labels, label_lengths, blank)
