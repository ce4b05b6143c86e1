"""Flash-attention forward: the hand-written Hopper kernel, its plain
PyTorch version, and the reference attention.

Counterpart of ``w2v2_speaker_tpu/ops/flash_attention.py``:

- ``reference_attention``  <- ``reference_attention`` (:65)
- ``flash_attention``      <- the inference path of ``_fwd_kernel`` (:204),
  launched by ``_fwd_call`` (:299, ``pallas_call`` at :360) with
  ``save_lse=False`` and dropout rate 0. The LSE output and the in-kernel
  counter-hash dropout come with the backward kernels (ROADMAP Queue 2,
  items 2-3).

Kernel: ``csrc/flash_attention_fwd.cu``. It replaces ``_fwd_kernel``. It is
memory-bound at the 3 s shape (B=48, T=149, H=12, d=64: 3.3 GFLOP, 44 MB,
bound ~13 us on an H100 SXM) and compute-bound on full utterances (B=8,
T=1500: 55 GFLOP, 74 MB, bound ~56 us). Design: one block per
(batch*head, 64-row q tile); q tiles past the length write zeros; K/V tiles
of 64 rows staged in shared memory only up to the length, the boundary tile
masked; bf16 products on the tensor cores (``mma.sync`` m16n8k16, f32
accumulate), f32 inputs on scalar f32 FMAs; online softmax in exp2 with the
running max, sum and accumulator in f32 registers. The kernel reads the
``[B, T, H, D]`` layout through strides (no repack), so the q/k/v views of
the fused QKV projection go in as they are.

Unlike the JAX package (``flash_attention`` :814, ``_kernel_profitable``
:794), there is no short-sequence dispatch: on a CUDA tensor every call
launches the kernel, at every length. On a CPU tensor the call runs the
plain version. Semantics of both: keys at positions >= ``lengths[b]`` are
excluded; query rows at positions >= ``lengths[b]`` output exactly 0
(``reference_attention`` gives padded rows values; downstream pooling masks
them, so embeddings agree).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "kernel_tolerance",
    "reference_attention",
    "HEAD_DIM",
]

LOG2E = math.log2(math.e)
HEAD_DIM = 64  # the kernel's one head size (wav2vec2 BASE and LARGE)
_NEG = torch.finfo(torch.float32).min
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
BF16_RTOL, BF16_ATOL_RMS = 2e-2, 2.0**-5  # see kernel_tolerance
_fwd_fn = None


def reference_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,  # [B, Tk] validity
) -> torch.Tensor:
    """Softmax attention over valid keys (<- ``reference_attention`` :65)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], _NEG)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _int32_lengths(
    lengths: Optional[torch.Tensor], b: int, device: torch.device
) -> Optional[torch.Tensor]:
    """``lengths`` as a contiguous [B] int32 tensor on ``device`` (no copy
    when it already is one, as the encoder's per-forward lengths are)."""
    if lengths is None:
        return None
    if lengths.shape != (b,):
        raise ValueError(f"lengths must have shape ({b},), got {tuple(lengths.shape)}")
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _lengths(
    lengths: Optional[torch.Tensor], b: int, t: int, device: torch.device
) -> torch.Tensor:
    """[B] int32 suffix lengths on ``device``, clamped to [0, T] (the kernel
    clamps the same way). Zero is a real input: all-invalid padding rows of
    a batch have length 0, and the frame count of an empty waveform is
    negative before the clamp."""
    lens = _int32_lengths(lengths, b, device)
    if lens is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return lens.clamp(0, t)


def _scale(d: int, dtype: torch.dtype) -> torch.Tensor:
    # the prescale constant rounded to the working type, as the JAX `_prep`
    # (:671) does with jnp.asarray(scale * log2e, q.dtype)
    return torch.tensor(d**-0.5 * LOG2E, dtype=dtype)


def flash_attention_plain(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (one dense pass, no tiling).

    Rounds where the kernel rounds: qs = q * scale in the input type, P to
    the input type before P V; products accumulate in f32 and the row sum
    comes from the f32 P.
    """
    b, t, h, d = q.shape
    lens = _lengths(lengths, b, t, q.device)
    qs = q * _scale(d, q.dtype).to(q.device)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]  # [B, T]
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).transpose(1, 2)[..., None]  # [B, T, H, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()) / l
    o = torch.where(valid[:, :, None, None], o, 0.0)
    return o.to(q.dtype)


def kernel_tolerance(want: torch.Tensor) -> Tuple[float, float]:
    """``(rtol, atol)`` for the kernel against ``flash_attention_plain``,
    given the plain version's valid output rows ``want``.

    float32: the JAX kernel tests' 2e-4 / 2e-5. bfloat16: each output is
    rounded to bf16 once (two roundings differ by an ulp, 2^-8 to 2^-7 of
    |o|), and each softmax weight is rounded to bf16 against a K tile's
    running max in the kernel but against the row's final max in the plain
    version (2^-9 of each weight, summing to a small share of the output's
    scale). So rtol is the JAX kernel tests' bf16 2e-2, and atol, in place
    of their fixed 2e-2, is 2^-5 of the RMS of ``want``: on long rows o
    shrinks as 1/sqrt(len) (RMS ~0.03 at len 3200), and so does the limit.
    The readings of this limit on the kernel and on planted faults come
    from ``tools/torch_fault_probe.py``.
    """
    if want.dtype == torch.float32:
        return 2e-4, 2e-5
    rms = want.float().square().mean().sqrt().item() if want.numel() else 0.0
    return BF16_RTOL, BF16_ATOL_RMS * rms


def _check_kernel_inputs(q, k, v) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"flash_attention kernel takes bfloat16 or float32 q/k/v of one "
            f"type, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes D={HEAD_DIM}, got {q.shape[-1]}")
    vec = 16 // q.element_size()  # the kernel moves 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel needs a contiguous last dim, strides that "
                f"are multiples of {vec} elements and a 16-byte aligned start; "
                f"got strides {x.stride()}"
            )


def bind(lib: ctypes.CDLL):
    """The C entry point of a built ``flash_attention_fwd`` library, typed."""
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_fwd_error.argtypes = [ctypes.c_int]
    lib.flash_attention_fwd_error.restype = ctypes.c_char_p
    return fn


def _kernel():
    global _fwd_fn
    if _fwd_fn is None:
        _fwd_fn = bind(_build.load("flash_attention_fwd"))
    return _fwd_fn


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # [B] int suffix lengths
) -> torch.Tensor:
    """Suffix-masked attention forward, ``[B, T, H, D]`` in and out.

    A CUDA tensor launches the kernel (and counts the launch in
    ``flash_attention.launches``) or raises; a CPU tensor runs
    ``flash_attention_plain``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_kernel_inputs(q, k, v)
    b, t, h, d = q.shape
    lens = _int32_lengths(lengths, b, q.device)  # the kernel clamps to [0, T]
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lens is None else lens.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            b, t, h,
            float(_scale(d, q.dtype)), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = _build.load("flash_attention_fwd").flash_attention_fwd_error(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
