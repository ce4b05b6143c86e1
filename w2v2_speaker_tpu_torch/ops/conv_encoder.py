"""Fused stride-2 conv + bias + LayerNorm + GELU of the wav2vec2 feature
encoder: the hand-written Hopper kernel, its plain PyTorch version and the
autograd wiring.

Counterpart of ``w2v2_speaker_tpu/ops/conv_encoder.py``:

- ``eligible``             <- ``eligible`` (:48)
- ``conv_fused_reference`` <- ``conv_fused_reference`` (:83), the plain version
- ``strided_conv_fused``   <- ``strided_conv_fused`` (:175) / ``_forward``
  (:198): the kernel ``csrc/conv_encoder.cu`` on a CUDA tensor, replacing
  ``_kernel`` (:120, ``pallas_call`` :241)
- ``StridedConvFusedFunction`` <- the custom_vjp ``_fwd`` / ``_bwd``
  (:267-301): the forward is the kernel, the backward the gradient of the
  plain formulation, recomputed (the JAX package has no backward kernel)

Layouts are the JAX package's: x channels-last ``[B, T_in, C]``, w in the
flax ``[k, C_in, C_out]`` layout (the port's ``nn.Conv1d`` weight
``[C_out, C_in, k]`` is ``w.permute(2, 1, 0)`` of it). The TPU block size
(``block_t``) and the host-side seam gather of the pair-phase formulation
are not carried over: in channels-last layout the k input frames of output
frame t are k*C contiguous elements, so the kernel reads the conv as one
GEMM whose A rows overlap (see the source).

On a CUDA tensor ``strided_conv_fused`` launches the kernel (counted in
``strided_conv_fused.launches``) or raises; on a CPU tensor it runs the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ..device import DeviceError

__all__ = [
    "StridedConvFusedFunction",
    "conv_fused_reference",
    "eligible",
    "kernel_tolerance",
    "strided_conv_fused",
    "MAX_CHANNELS",
]

MAX_CHANNELS = 512  # the kernel's widest layer (wav2vec2's conv_dim)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
BF16_RTOL, BF16_ATOL_RMS = 2e-2, 2.0**-5  # see kernel_tolerance
_fn = None


def eligible(kernel: int, stride: int, c_in: int, c_out: int) -> bool:
    """The shapes of the fused kernel: wav2vec2's conv layers 1-6."""
    return stride == 2 and kernel in (2, 3) and c_in == c_out and c_in % 128 == 0


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 2.0**-0.5))


def conv_fused_reference(
    x: torch.Tensor,  # [B, T_in, C]
    w: torch.Tensor,  # [k, C, C]
    bias: Optional[torch.Tensor] = None,
    ln_scale: Optional[torch.Tensor] = None,
    ln_bias: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-5,
    fuse_gelu: bool = True,
) -> torch.Tensor:
    """Stride-2 VALID conv (+ bias) (+ LayerNorm over C) (+ exact GELU),
    ``[B, (T_in - k) // 2 + 1, C]`` in x's type.

    Rounds where the kernel rounds: w to x's type first (the kernel reads
    both in one type), then everything in float32, x and w upcast, the
    LayerNorm's variance two-pass, and one rounding to x's type at the end.
    The conv is the kernel's GEMM: the k frames of each output frame
    (``unfold``) times the weights."""
    k = w.shape[0]
    frames = x.float().unfold(1, k, 2)  # [B, T_out, C, k]
    out = torch.einsum("btck,kcn->btn", frames, w.to(x.dtype).float())
    if bias is not None:
        out = out + bias.float()
    if ln_scale is not None:
        mu = out.mean(-1, keepdim=True)
        var = (out - mu).square().mean(-1, keepdim=True)
        out = (out - mu) * torch.rsqrt(var + ln_eps) * ln_scale.float() + ln_bias.float()
    if fuse_gelu:
        out = _gelu_exact(out)
    return out.to(x.dtype)


def kernel_tolerance(want: torch.Tensor) -> Tuple[float, float]:
    """``(rtol, atol)`` for the kernel against its plain version, given the
    plain version's output ``want``.

    float32: the JAX kernel tests' bias + LayerNorm limit, 2e-4 / 2e-5
    (``tests/test_conv_encoder.py``); both sum the same f32 products in
    other orders. bfloat16: both round one f32 value to bf16 once, and the
    f32 values differ in their last bits, so an element can land one bf16
    ulp (2^-8 to 2^-7 of it) apart: rtol 2e-2, and an atol of 2^-5 of the
    RMS of ``want`` for elements near 0, as ``flash_attention`` has it.
    """
    if want.dtype == torch.float32:
        return 2e-4, 2e-5
    rms = want.float().square().mean().sqrt().item() if want.numel() else 0.0
    return BF16_RTOL, BF16_ATOL_RMS * rms


def bind(lib: ctypes.CDLL):
    """The C entry point of a built ``conv_encoder`` library, typed."""
    fn = lib.conv_encoder_fused
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.conv_encoder_error.argtypes = [ctypes.c_int]
    lib.conv_encoder_error.restype = ctypes.c_char_p
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(_build.load("conv_encoder"))
    return _fn


def _f32_param(p: Optional[torch.Tensor], c: int, name: str, device) -> Optional[torch.Tensor]:
    if p is None:
        return None
    if p.shape != (c,):
        raise ValueError(f"{name} must have shape ({c},), got {tuple(p.shape)}")
    return p.to(device=device, dtype=torch.float32).contiguous()


def strided_conv_fused(
    x: torch.Tensor,  # [B, T_in, C]
    w: torch.Tensor,  # [k, C, C]
    bias: Optional[torch.Tensor] = None,
    ln_scale: Optional[torch.Tensor] = None,
    ln_bias: Optional[torch.Tensor] = None,
    ln_eps: float = 1e-5,
    fuse_gelu: bool = True,
) -> torch.Tensor:
    """``conv_fused_reference``'s function: the kernel on a CUDA tensor
    (counted in ``strided_conv_fused.launches``), the plain version on a
    CPU tensor. x and w are read in x's type (bfloat16 or float32), bias
    and the LayerNorm parameters in float32."""
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("ln_scale and ln_bias come together")
    b, t_in, c = x.shape
    k = w.shape[0]
    if not eligible(k, 2, c, w.shape[-1]) or w.shape != (k, c, c) or t_in < k:
        raise ValueError(f"strided_conv_fused takes k in (2, 3), T_in >= k and C -> C with "
                         f"C % 128 == 0, got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv_fused_reference(x, w, bias, ln_scale, ln_bias, ln_eps, fuse_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"strided_conv_fused runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"strided_conv_fused kernel takes bfloat16 or float32 x, got {x.dtype}")
    if c > MAX_CHANNELS:
        raise ValueError(f"strided_conv_fused kernel takes C <= {MAX_CHANNELS}, got {c}")
    t_out = (t_in - k) // 2 + 1
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("strided_conv_fused kernel needs a 16-byte aligned x (its tensor "
                         "maps and vector loads)")
    # the GEMM's B operand: bf16 as [C_out, k*C_in] (rows along the
    # contraction: the K-major B tile of wgmma), f32 as [k*C_in, C_out]
    wd = w.to(device=x.device, dtype=x.dtype)
    wk = wd.permute(2, 0, 1).reshape(c, k * c) if x.dtype == torch.bfloat16 else wd.reshape(k * c, c)
    wk = wk.contiguous()
    params = [_f32_param(p, c, n, x.device)
              for p, n in ((bias, "bias"), (ln_scale, "ln_scale"), (ln_bias, "ln_bias"))]
    out = torch.empty((b, t_out, c), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), wk.data_ptr(),
            *(None if p is None else p.data_ptr() for p in params),
            out.data_ptr(), b, t_in, t_out, c, k, float(ln_eps), int(fuse_gelu),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = _build.load("conv_encoder").conv_encoder_error(err).decode()
        raise DeviceError(f"conv_encoder launch failed: {msg} ({err})")
    strided_conv_fused.launches += 1
    return out


strided_conv_fused.launches = 0


class StridedConvFusedFunction(torch.autograd.Function):
    """Differentiable ``strided_conv_fused`` (the custom_vjp of the JAX
    module, :267-301). The forward runs with autocast off: x is taken in
    its own type (the caller casts it to the compute type), w is cast to
    x's type, bias and the LayerNorm parameters are read in float32, and
    the gradients reach the parameters through those casts. It saves its
    inputs and the backward differentiates ``conv_fused_reference`` on
    them, recomputed in float32: the gradient of the plain formulation, as
    JAX's ``_bwd`` (:277) takes ``jax.vjp`` of it. Nothing here is random."""

    @staticmethod
    def forward(ctx, x, w, bias, ln_scale, ln_bias, ln_eps, fuse_gelu):
        with torch.autocast(x.device.type, enabled=False):
            y = strided_conv_fused(x, w, bias, ln_scale, ln_bias, ln_eps, fuse_gelu)
        ctx.save_for_backward(x, w, bias, ln_scale, ln_bias)
        ctx.ln_eps, ctx.fuse_gelu = ln_eps, fuse_gelu
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inputs = [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:5])
        ]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad(), torch.autocast(g.device.type, enabled=False):
                y = conv_fused_reference(*inputs, ctx.ln_eps, ctx.fuse_gelu)
                grads = iter(torch.autograd.grad(y, wanted, g))
        out = [next(grads) if t is not None and t.requires_grad else None for t in inputs]
        return (*out, None, None)
