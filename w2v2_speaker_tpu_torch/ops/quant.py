"""Dynamic int8 matmuls for serving: the hand-written Hopper kernels, their
plain PyTorch versions and the ``nn.Linear`` that uses them.

Counterpart of ``w2v2_speaker_tpu/ops/quant.py``:

- ``INT8_AUTO_MIN_SAMPLES`` (:49) and ``int8_auto_policy`` (:52), the
  per-bucket rule of ``network.int8_matmuls=auto``. The default is the
  JAX package's, kept as the knob's default; the card's own crossover is
  measured by ``chip_smoke.py`` and recorded in PERF.md, not applied.
- ``quantize_rows`` <- ``_rowwise_quantize`` (:70): symmetric absmax per
  row, ``scale = absmax / 127`` (1 for a zero row), ``q = clip(round(x /
  scale), -127, 127)`` rounding half to even. The kernel
  ``int8_quantize_rows`` of ``csrc/int8_matmul.cu`` on a CUDA tensor,
  ``quantize_rows_reference`` on a CPU tensor.
- ``int8_gemm``: int8 ``[M, K]`` x int8 ``[N, K]`` into int32 sums, then
  ``(float(acc) * xs[m]) * ks[n]`` (+ ``bias[n]``) in float32, rounded
  once to the output type. The kernel ``int8_gemm`` on a CUDA tensor,
  ``int8_gemm_reference`` on a CPU tensor.
- ``int8_matmul`` <- ``int8_matmul`` (:83): activations per row, weights
  per output channel, both quantized at each call as the JAX package does.
  The weight is a torch ``Linear`` weight ``[N, K]``: its rows are the
  reference kernel's per-output-channel columns (``kernel.T``).
- ``QuantLinear`` <- ``QuantDense`` (:102).

The JAX package leaves its int8 dot and the passes around it to XLA (no
``pallas_call``); the kernels here are the port's own, so that the
quantize is one pass and the rescale stays in the GEMM's registers. The
GEMM is a warp-specialised ``wgmma`` s8 kernel over a TMA ring of
128-byte-swizzled stages, persistent blocks walking 128 x N output tiles
(N of 64-256 chosen per launch; ``gemm_tile`` reads the choice), its
output stored by TMA from shared memory; the quantize reads each row once
with 16-byte loads (``csrc/int8_matmul.cu`` has the design and what holds
each kernel).

On a CUDA tensor each wrapper launches its kernel (counted in
``quantize_rows.launches`` and ``int8_gemm.launches``) or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import _build
from ..device import DeviceError

__all__ = [
    "INT8_AUTO_MIN_SAMPLES",
    "QuantLinear",
    "gemm_tile",
    "int32_dot",
    "int8_auto_policy",
    "int8_enabled",
    "int8_gemm",
    "int8_gemm_reference",
    "int8_matmul",
    "quantize_rows",
    "quantize_rows_reference",
]

# The JAX package's BASE crossover for int8_matmuls=auto (6 s of 16 kHz
# audio, measured on a TPU v5e and kept as the default of
# network.int8_auto_min_samples). On an H100 int8 loses to bf16 at every
# shape measured (PERF.md §5): auto is then slower than full precision.
INT8_AUTO_MIN_SAMPLES = 6 * 16000
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_lib = None


def int8_auto_policy(padded_samples: int, hidden_size: int, min_samples: int = INT8_AUTO_MIN_SAMPLES) -> bool:
    """Int8 for a bucket batch of ``padded_samples`` samples: always for
    LARGE (``hidden_size >= 1024``), for BASE from ``min_samples`` on."""
    if hidden_size >= 1024:
        return True
    return padded_samples >= min_samples


def quantize_rows_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., K]`` -> (int8 ``[..., K]``, float32 scales ``[...]``):
    the plain version, in the kernel's order of float32 operations."""
    x32 = x.float()
    absmax = x32.abs().amax(-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its rounded reciprocal, which is not the IEEE quotient
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def int32_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 sums ``xq [M, K] @ wq [N, K]^T``, exact: in float64 every
    partial sum is an integer below 2^53 (|sum| <= 127^2 K), on the CPU and
    on the card alike (whose int32 matmul PyTorch does not offer)."""
    return (xq.double() @ wq.double().T).to(torch.int32)


def int8_gemm_reference(
    xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ks: torch.Tensor,
    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version of ``int8_gemm``: ``(float(acc) * xs[:, None]) *
    ks[None, :]``, then ``+ bias`` in float32, rounded once to
    ``out_dtype``."""
    out = int32_dot(xq, wq).float() * xs.float()[:, None] * ks.float()[None, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A built ``int8_matmul`` library with its C entry points typed."""
    lib.int8_quantize_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.int8_gemm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.int8_gemm_tile_n.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.int8_quantize_rows.restype = lib.int8_gemm.restype = lib.int8_gemm_tile_n.restype = ctypes.c_int
    lib.int8_matmul_error.argtypes = [ctypes.c_int]
    lib.int8_matmul_error.restype = ctypes.c_char_p
    return lib


def _kernels():
    global _lib
    if _lib is None:
        _lib = bind(_build.load("int8_matmul"))
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise DeviceError(f"{name} launch failed: {_kernels().int8_matmul_error(err).decode()} ({err})")


def _on_card(x: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows_reference``'s function: the kernel on a CUDA tensor
    (bfloat16 or float32), the plain version on a CPU tensor."""
    if not _on_card(x, "quantize_rows"):
        return quantize_rows_reference(x)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"quantize_rows kernel takes bfloat16 or float32, got {x.dtype}")
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    q = torch.empty(x2.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device)
    if x2.numel():
        with torch.cuda.device(x.device):
            _check(_kernels().int8_quantize_rows(
                x2.data_ptr(), _DTYPE_CODES[x.dtype], q.data_ptr(), scales.data_ptr(), x2.shape[0], k,
                torch.cuda.current_stream(x.device).cuda_stream), "int8_quantize_rows")
        quantize_rows.launches += 1
    return q.view(x.shape), scales.view(x.shape[:-1])


quantize_rows.launches = 0


def int8_gemm(
    xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor, ks: torch.Tensor,
    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``int8_gemm_reference``'s function on ``xq [M, K]``, ``wq [N, K]``
    (int8), ``xs [M]``, ``ks [N]`` and ``bias [N]`` (float32): the kernel
    on CUDA tensors (counted in ``int8_gemm.launches``; a K that is not a
    multiple of 16 is padded with zeros first), the plain version on CPU
    tensors."""
    m, k = xq.shape
    n = wq.shape[0]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape != (n, k):
        raise ValueError(f"int8_gemm takes int8 [M, K] x [N, K], got {xq.dtype} {tuple(xq.shape)}, "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if xs.shape != (m,) or ks.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError("int8_gemm scales and bias must be [M], [N] and [N]")
    if not _on_card(xq, "int8_gemm"):
        return int8_gemm_reference(xq, wq, xs, ks, bias, out_dtype)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_gemm kernel writes bfloat16 or float32, got {out_dtype}")
    if k % 16:
        xq, wq = (F.pad(t, (0, 16 - k % 16)) for t in (xq, wq))
    xq, wq = xq.contiguous(), wq.contiguous()
    f32 = [None if t is None else t.to(device=xq.device, dtype=torch.float32).contiguous() for t in (xs, ks, bias)]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m and n:
        with torch.cuda.device(xq.device):
            _check(_kernels().int8_gemm(
                xq.data_ptr(), wq.data_ptr(), *(None if t is None else t.data_ptr() for t in f32),
                out.data_ptr(), _DTYPE_CODES[out_dtype], m, n, xq.shape[1],
                torch.cuda.current_stream(xq.device).cuda_stream), "int8_gemm")
        int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def gemm_tile(m: int, n: int) -> Tuple[int, int]:
    """The output tile ``(rows, columns)`` that the ``int8_gemm`` kernel's
    launch rule takes for ``[M, K] x [N, K]`` on the current card (read
    from the kernel's library; needs the card)."""
    return 128, _kernels().int8_gemm_tile_n(m, n)


def int8_matmul(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``x [..., K]`` times the ``Linear`` weight ``[N, K]`` through dynamic
    int8: x quantized per row, the weight per output channel (its rows),
    the int32 product rescaled in float32, ``bias`` added in float32, the
    result ``[..., N]`` in ``out_dtype``. The JAX ``int8_matmul(x,
    kernel)`` is ``int8_matmul(x, kernel.T)`` here."""
    k = x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, k))
    wq, ks = quantize_rows(weight)
    out = int8_gemm(xq, wq, xs, ks, bias, out_dtype)
    return out.view(*x.shape[:-1], weight.shape[0])


class QuantLinear(nn.Linear):
    """``nn.Linear`` whose product runs as dynamic int8 (<- ``QuantDense``
    :102): the same parameters, names and layout (``weight [out, in]``,
    ``bias [out]``), so checkpoints and ``models/convert.py`` load
    unchanged. The output is in the compute type: the autocast type under
    autocast (x is cast to it first, as ``F.linear`` casts it), x's type
    otherwise, as flax's ``dtype=`` sets it.

    Inference only: a forward that would need a gradient raises (the JAX
    ``QuantDense`` gives zero gradients through its round, silently).
    ``int8`` False makes it ``nn.Linear`` (``int8_enabled`` switches a
    model's sites per call for ``network.int8_matmuls=auto``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.int8 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.int8:
            return super().forward(x)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, self.weight, self.bias)):
            raise RuntimeError(
                "QuantLinear (network.int8_matmuls=true) is inference only: int8 matmuls have no gradient; "
                "train in full precision, serve int8 (predict, or fit_model=false)")
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        with torch.autocast(dev, enabled=False):
            return int8_matmul(x.to(dtype), self.weight, self.bias, dtype)


def int8_enabled(model: nn.Module, enabled: bool) -> int:
    """Switch every ``QuantLinear`` of ``model`` to int8 (True) or to its
    ``nn.Linear`` product (False); returns how many were switched."""
    sites = [m for m in model.modules() if isinstance(m, QuantLinear)]
    for m in sites:
        m.int8 = enabled
    return len(sites)
