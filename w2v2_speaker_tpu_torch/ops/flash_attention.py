"""Flash attention: the hand-written Hopper kernels, their plain PyTorch
versions, the counter-hash dropout sampler and the autograd wiring.

Counterpart of ``w2v2_speaker_tpu/ops/flash_attention.py``:

- ``reference_attention``     <- ``reference_attention`` (:65)
- ``attention_dropout_keep``  <- ``_dropout_keep`` (:83) and
  ``attention_dropout_keep`` (:109); ``draw_seed`` takes the role of
  ``dropout_seed_from_rng`` (:146) with an explicit ``torch.Generator``
- ``flash_attention``         <- ``flash_attention_kernel`` (:758) and the
  ``_flash_attention`` custom_vjp (:697-755), as ``FlashAttentionFunction``
- forward kernel  ``csrc/flash_attention_fwd.cu`` <- ``_fwd_kernel`` (:204),
  launched by ``_fwd_call`` (:299, ``pallas_call`` at :360): with the
  log2-domain LSE output and the in-kernel dropout on P
- dq kernel  ``csrc/flash_attention_bwd.cu`` <- ``_bwd_dq_kernel`` (:381,
  ``pallas_call`` at :587)
- dk/dv kernel  ``csrc/flash_attention_bwd.cu`` <- ``_bwd_dkv_kernel`` (:465,
  ``pallas_call`` at :623)

Bounds (H100 SXM: 989 TFLOP/s bf16, 495 TF32, 3.35 TB/s): FLOPs 4 (forward),
6 (dq) and 8 (dk/dv) x H * d * sum(len^2), in f32 three TF32 products each
(3xTF32, the least work that keeps f32 accuracy on the tensor cores);
bytes the valid input rows read once and the outputs written once. At the
training shape (B=66, T=149, H=12, d=64, bf16) every kernel is bound by
bytes (~0.02-0.03 ms); on full utterances by operations. Design, shared by
the three kernels: a warpgroup per (batch*head, 64-row tile), a loop over
the other side's tiles only up to the row's length (only the boundary tile
masked); in bf16 the tiles arrive by ``cp.async`` into 128-byte-swizzled
shared memory, the next tile in flight while this one computes, and the
products are Hopper's ``wgmma`` (f32 accumulate), the first with both
operands in shared memory, the second with the first's accumulators,
rounded to bf16 in registers, as its A operand. With f32 inputs dq and
dk/dv run the same loops with each product as three TF32 products on
``wgmma`` (3xTF32: every float split into tf32 hi and lo parts), and the
forward scalar f32 FMAs. The keep mask of the dropout is regenerated in
every kernel from (seed, batch*head, q, k) by the same murmur3 finalizer,
so no [T, T] mask exists anywhere. Two backward kernels and no atomics, as
in the JAX package: gradients are deterministic.

On a CUDA tensor every call launches a kernel (each wrapper counts its
launches in ``.launches``) or raises; on a CPU tensor it runs the plain
version. There is no short-sequence dispatch (``_kernel_profitable`` :794).
Semantics of both: keys at positions >= ``lengths[b]`` are excluded; query
rows at positions >= ``lengths[b]`` output exactly 0, their LSE is 0, and
their gradients, like those of key rows past the length, are exactly 0
(``reference_attention`` gives padded rows values; downstream pooling masks
them, so embeddings and parameter gradients agree).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from ..device import DeviceError

__all__ = [
    "FlashAttentionFunction",
    "attention_bwd_float64",
    "attention_dropout_keep",
    "attention_delta",
    "draw_seed",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_plain",
    "backward_rounding_slack",
    "flash_attention_fwd",
    "flash_attention_plain",
    "keep_threshold",
    "kernel_tolerance",
    "norm_distance",
    "reference_attention",
    "HEAD_DIM",
]

LOG2E = math.log2(math.e)
HEAD_DIM = 64  # the kernels' one head size (wav2vec2 BASE and LARGE)
_NEG = torch.finfo(torch.float32).min
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
BF16_RTOL, BF16_ATOL_RMS = 2e-2, 2.0**-5  # see kernel_tolerance
_fwd_fn = None
_bwd_fns = None

# murmur3 finalizer constants of `_dropout_keep` (:95-105)
_M32 = 0xFFFFFFFF
_C_BH, _C_Q, _C_K = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_F1, _F2 = 0x85EBCA6B, 0xC2B2AE35


# ---------------------------------------------------------------------------
# counter-hash dropout sampler
# ---------------------------------------------------------------------------


def keep_threshold(rate: float) -> int:
    """An element is kept where its hash is >= this (:106)."""
    return min(int(rate * 2**32), 2**32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): the product is
    split in 16-bit halves of ``c`` so no int64 product overflows (PyTorch
    has no uint32 shifts on the CPU)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


Coords = Tuple[int, int, int]  # (row0, head0, heads) of the dropout hash; heads 0: the call's own H


def attention_dropout_keep(
    seed: int, b: int, h: int, tq: int, tk: int, rate: float,
    device: Optional[torch.device] = None, coords: Coords = (0, 0, 0),
) -> torch.Tensor:
    """[B, H, Tq, Tk] bool keep mask, bit-identical to the JAX package's for
    the same int32 ``seed``: the murmur3 finalizer over the absolute
    (b * H + h, q, k) coordinates, in int64 masked to 32 bits. ``coords``
    = (row0, head0, heads) places the block in a global batch: its rows are
    global rows row0.., its heads heads head0.. of ``heads`` (0: ``h``),
    so the mask is the global mask's [row0:row0 + b, head0:head0 + h]."""
    row0, head0, heads = coords
    rows = torch.arange(row0, row0 + b, dtype=torch.int64, device=device)
    hs = torch.arange(head0, head0 + h, dtype=torch.int64, device=device)
    bh = (rows[:, None] * (heads or h) + hs[None, :]).reshape(-1)

    def coord(n: int, c: int) -> torch.Tensor:
        return _mul32(torch.arange(n, dtype=torch.int64, device=device), c)

    x = (
        (seed & _M32)
        + _mul32(bh, _C_BH)[:, None, None]
        + coord(tq, _C_Q)[None, :, None]
        + coord(tk, _C_K)[None, None, :]
    ) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _F1)
    x = x ^ (x >> 13)
    x = _mul32(x, _F2)
    x = x ^ (x >> 16)
    return (x >= keep_threshold(rate)).reshape(b, h, tq, tk)


def draw_seed(generator: torch.Generator) -> int:
    """One int32 dropout seed from ``generator`` (the role of
    ``dropout_seed_from_rng`` :146: uniform over [-2**31, 2**31 - 1))."""
    return int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=generator))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


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
    """[B] int32 suffix lengths on ``device``, clamped to [0, T] (the kernels
    clamp the same way). Zero is a real input: all-invalid padding rows of
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


def _keep_scale(rate: float) -> float:
    """1 / (1 - rate), as the float32 the kernels multiply by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _check_dropout(dropout_rate: float, seed: Optional[int]) -> None:
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")


def _autocast_off(fn):
    """Run a plain version with autocast off: it rounds where the kernel
    rounds and sums in float32, and an autocast region (bf16 training on
    the CPU) would round its float32 products and scores to bf16 again."""

    @functools.wraps(fn)
    def run(q, *args, **kwargs):
        with torch.autocast(q.device.type, enabled=False):
            return fn(q, *args, **kwargs)

    return run


def _plain_inputs(q, k, lengths, dtype):
    """(valid [B, T], qs = q * scale rounded to ``dtype`` then float32, the
    [B, H, T, T] float32 scores qs K^T with the float32 minimum added on
    the keys past each row's length)."""
    b, t, h, d = q.shape
    lens = _lengths(lengths, b, t, q.device)
    qs = (q * _scale(d, dtype).to(q.device)).float()
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]  # [B, T]
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    # a score plus the float32 minimum rounds to it: the masked_fill of the
    # kernels' key mask, in place
    return valid, qs, s.add_(torch.where(valid, 0.0, _NEG)[:, None, None, :])


@_autocast_off
def flash_attention_plain(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # [B] int
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    return_lse: bool = False,
    coords: Coords = (0, 0, 0),
):
    """The forward kernel's function in plain PyTorch (one dense pass, its
    [B, H, T, T] scores updated in place).

    Rounds where the kernel rounds: qs = q * scale in the input type, the
    (dropped, rescaled) P to the input type before P V; products accumulate
    in f32 and the row sum comes from the f32 undropped P. With
    ``return_lse`` also returns the [B, H, T] f32 log2-domain LSE
    ``m + log2(l)``, 0 on rows past the length. ``coords``: the dropout
    hash's global coordinates (``attention_dropout_keep``).
    """
    _check_dropout(dropout_rate, seed)
    b, t, h, d = q.shape
    valid, _, p = _plain_inputs(q, k, lengths, q.dtype)
    m = p.amax(dim=-1, keepdim=True)
    p.sub_(m).exp2_()
    l = p.sum(dim=-1, keepdim=True)  # [B, H, T, 1]
    if dropout_rate > 0.0:
        keep = attention_dropout_keep(seed, b, h, t, t, dropout_rate, q.device, coords)
        p.mul_(_keep_scale(dropout_rate)).masked_fill_(~keep, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.transpose(1, 2)
    o = torch.where(valid[:, :, None, None], o, 0.0).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(valid[:, None, :], (m + torch.log2(l))[..., 0], 0.0)
    return o, lse


@_autocast_off
def flash_attention_bwd_plain(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,  # [B, T, H, D]
    lse: torch.Tensor,  # [B, H, T] f32
    delta: torch.Tensor,  # [B, H, T] f32, rowsum(dO * O)
    lengths: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    coords: Coords = (0, 0, 0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels' function in plain PyTorch: one dense pass
    over the formulas of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, its
    [B, H, T, T] terms updated in place.

    P = exp2(qs K^T - lse) on valid (q, k) pairs, 0 elsewhere; dP = dO V^T,
    kept and rescaled; dZ = P (dP - D). dq = (dZ K) * d^-0.5, dk = dZ^T qs /
    log2 e, dv = P~^T dO with P~ the dropped P. dZ and P~ are rounded to the
    input type before their products, dq to the input type before the
    scale, as the kernels do. Rows past the length are exactly 0.
    """
    _check_dropout(dropout_rate, seed)
    b, t, h, d = q.shape
    dtype = q.dtype
    valid, qs, p = _plain_inputs(q, k, lengths, dtype)
    # the masked keys' scores give exp2(min - lse) = 0; the rows past the length 0
    p.sub_(lse[..., None]).exp2_().masked_fill_(~valid[:, None, :, None], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    pv = p
    if dropout_rate > 0.0:
        keep = attention_dropout_keep(seed, b, h, t, t, dropout_rate, q.device, coords)
        inv = _keep_scale(dropout_rate)
        pv = torch.where(keep, p * inv, 0.0)
        dp.mul_(inv).masked_fill_(~keep, 0.0)
    dz = dp.sub_(delta[..., None]).mul_(p).to(dtype).float()
    rows = valid[:, :, None, None]
    dqs = torch.einsum("bhqk,bkhd->bqhd", dz, k.float()).to(dtype)
    dq = torch.where(rows, dqs * torch.tensor(d**-0.5, dtype=dtype), 0.0)
    dk = torch.einsum("bhqk,bqhd->bkhd", dz, qs) / LOG2E
    dv = torch.einsum("bhqk,bqhd->bkhd", pv.to(dtype).float(), do.float())
    dk = torch.where(rows, dk, 0.0)
    dv = torch.where(rows, dv, 0.0)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


@_autocast_off
@torch.no_grad()
def attention_bwd_float64(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, lengths: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seed: Optional[int] = None, coords: Coords = (0, 0, 0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The formulas of ``flash_attention_bwd_plain`` for float32 inputs
    evaluated in float64 (from the same float32 lse and D, qs = q times the
    float32 scale, no rounding to the input type): the yardstick of the
    float32 routes' accuracy. float64 (dq, dk, dv), rows past the length 0.
    ``norm_distance`` of a float32 route's output from it measures that
    route's rounding."""
    _check_dropout(dropout_rate, seed)
    b, t, h, d = q.shape
    lens = _lengths(lengths, b, t, q.device)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    qs = q.double() * float(_scale(d, torch.float32))
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.double())
    pairs = valid[:, None, :, None] & valid[:, None, None, :]
    p = torch.where(pairs, torch.exp2(s - lse.double()[..., None]), 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
    pv = p
    if dropout_rate > 0.0:
        keep = attention_dropout_keep(seed, b, h, t, t, dropout_rate, q.device, coords)
        inv = _keep_scale(dropout_rate)
        pv = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
        del keep
    dz = p * (dp - delta.double()[..., None])
    del p, dp
    rows = valid[:, :, None, None]
    dq = torch.where(rows, torch.einsum("bhqk,bkhd->bqhd", dz, k.double()) * d**-0.5, 0.0)
    dk = torch.where(rows, torch.einsum("bhqk,bqhd->bkhd", dz, qs) / LOG2E, 0.0)
    dv = torch.where(rows, torch.einsum("bhqk,bqhd->bkhd", pv, do.double()), 0.0)
    return dq, dk, dv


def norm_distance(got: torch.Tensor, exact: torch.Tensor) -> float:
    """|got - exact| / |exact| (L2 norms over the whole tensor, float64); 0
    where both are 0."""
    err, norm = float((got.double() - exact).norm()), float(exact.norm())
    return err / norm if norm > 0 else (0.0 if err == 0 else float("inf"))


def kernel_tolerance(want: torch.Tensor, backward: bool = False) -> Tuple[float, float]:
    """``(rtol, atol)`` for a kernel against its plain version, given the
    plain version's valid output rows ``want``.

    float32: the JAX kernel tests' forward 2e-4 / 2e-5 and backward 5e-4 /
    5e-5 (``tests/test_flash_attention.py``). bfloat16, forward and
    backward: each output is rounded to bf16 once (two roundings differ by
    an ulp, 2^-8 to 2^-7 of |o|), and P (forward) or dZ and P~ (backward)
    are rounded to bf16 from f32 values that the kernel and the plain
    version sum in other orders, so single elements differ by an ulp. So
    rtol is the JAX kernel tests' bf16 2e-2, and atol, in place of their
    fixed 2e-2, is 2^-5 of the RMS of ``want``: on long rows the outputs
    shrink as 1/sqrt(len), and so does the limit. The readings of these
    limits on the kernels and on planted faults come from
    ``tools/torch_fault_probe.py``. dk and dv also add, per element, one
    rounding of the bf16 P~ or dZ they sum over (``backward_rounding_slack``).
    """
    if want.dtype == torch.float32:
        return (5e-4, 5e-5) if backward else (2e-4, 2e-5)
    rms = want.float().square().mean().sqrt().item() if want.numel() else 0.0
    return BF16_RTOL, BF16_ATOL_RMS * rms


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits): 2^(e-8)
    for |x| in [2^(e-1), 2^e); 0 at 0, which rounds exactly."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def _max_product(a: torch.Tensor, b: torch.Tensor, budget: int = 2**27) -> torch.Tensor:
    """max over q of a[b, h, q, k] * b[b, q, h, d] for non-negative ``a``
    [B, H, Tq, Tk] and ``b`` [B, Tq, H, D]: [B, Tk, H, D], in chunks of keys
    that keep each [B, H, Tq, keys, D] product under ``budget`` elements."""
    bsz, h, tq, tk = a.shape
    bt = b.permute(0, 2, 1, 3)[:, :, :, None, :]  # [B, H, Tq, 1, D]
    step = max(1, budget // max(1, bsz * h * tq * b.shape[-1]))
    out = [(a[..., k0 : k0 + step, None] * bt).amax(dim=2) for k0 in range(0, tk, step)]
    return torch.cat(out, dim=2).permute(0, 2, 1, 3) if tq else a.new_zeros(bsz, tk, h, b.shape[-1])


@_autocast_off
@torch.no_grad()
def backward_rounding_slack(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, lengths: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    seed: Optional[int] = None, coords: Coords = (0, 0, 0),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Per-element additions to the bf16 limits of dk and dv, [B, T, H, D]
    float32 each (None, None for float32 inputs).

    dv[k] = sum_q P~[q, k] dO[q] and dk[k] = sum_q dZ[q, k] qs[q] / log2 e
    take P~ and dZ rounded to bf16 from float32 values that the kernel and
    the plain version compute in other orders. Where such a value lies
    within a hair of a rounding midpoint, the two round it to neighbouring
    bf16 numbers, and the sums differ by one bf16 ulp of it times the
    other factor. So an element may differ by the largest such term over
    its queries: max_q ulp(P~[q, k]) |dO[q, d]| for dv, max_q ulp(dZ[q, k])
    |qs[q, d]| / log2 e for dk, computed from the plain version's P~ and
    dZ. ``kernel_tolerance``'s atol scales with the RMS of the whole
    output, which long rows set, and misses one rounding in a short row.
    """
    if q.dtype != torch.bfloat16:
        return None, None
    _check_dropout(dropout_rate, seed)
    b, t, h, d = q.shape
    lens = _lengths(lengths, b, t, q.device)
    qs = q * _scale(d, q.dtype).to(q.device)
    valid = torch.arange(t, device=q.device)[None, :] < lens[:, None]
    pairs = valid[:, None, :, None] & valid[:, None, None, :]
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.where(pairs, torch.exp2(s - lse[..., None]), 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    pv = p
    if dropout_rate > 0.0:
        keep = attention_dropout_keep(seed, b, h, t, t, dropout_rate, q.device, coords)
        inv = _keep_scale(dropout_rate)
        pv = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
        del keep
    dv_slack = _max_product(_bf16_ulp(pv), do.float().abs())
    del pv
    dz = p * (dp - delta[..., None])
    del p, dp
    dk_slack = _max_product(_bf16_ulp(dz), qs.float().abs()) / LOG2E
    return dk_slack, dv_slack


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_kernel_inputs(**tensors: torch.Tensor) -> None:
    first = next(iter(tensors.values()))
    if any(x.device != first.device for x in tensors.values()):
        raise ValueError(f"{', '.join(tensors)} must be on one device")
    if first.dtype not in _DTYPE_CODES or any(x.dtype != first.dtype for x in tensors.values()):
        raise ValueError(
            f"flash_attention kernel takes bfloat16 or float32 {'/'.join(tensors)} of "
            f"one type, got {', '.join(str(x.dtype) for x in tensors.values())}"
        )
    if first.dim() != 4 or any(x.shape != first.shape for x in tensors.values()):
        raise ValueError(
            f"{', '.join(tensors)} must share one [B, T, H, D] shape, got "
            f"{', '.join(str(tuple(x.shape)) for x in tensors.values())}"
        )
    if first.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes D={HEAD_DIM}, got {first.shape[-1]}")
    vec = 16 // first.element_size()  # the kernels move 16-byte vectors
    for name, x in tensors.items():
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel needs a contiguous last dim, strides that "
                f"are multiples of {vec} elements and a 16-byte aligned start; "
                f"got strides {x.stride()}"
            )


def _check_row_stats(b: int, h: int, t: int, device, **stats: torch.Tensor) -> None:
    for name, x in stats.items():
        if x.shape != (b, h, t) or x.dtype != torch.float32 or x.device != device \
                or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 [B, H, T] = {(b, h, t)} tensor "
                f"on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )


def _dropout_args(dropout_rate: float, seed: Optional[int], coords: Coords, h: int):
    """(seed as uint32, keep threshold, 1 / (1 - rate), dropout flag, the
    hash's first global row, first head and heads a row)."""
    row0, head0, heads = coords
    if dropout_rate == 0.0:
        return 0, 0, 1.0, 0, 0, 0, h
    return seed & _M32, keep_threshold(dropout_rate), _keep_scale(dropout_rate), 1, row0, head0, heads or h


_DROPOUT_ARGTYPES = [ctypes.c_uint, ctypes.c_uint, ctypes.c_float] + [ctypes.c_int] * 4


def bind(lib: ctypes.CDLL):
    """The C entry point of a built ``flash_attention_fwd`` library, typed."""
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int]
        + _DROPOUT_ARGTYPES
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_fwd_error.argtypes = [ctypes.c_int]
    lib.flash_attention_fwd_error.restype = ctypes.c_char_p
    return fn


def bind_bwd(lib: ctypes.CDLL):
    """``(dq, dkv)`` C entry points of a built ``flash_attention_bwd``
    library, typed."""
    common = (
        [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int]
        + _DROPOUT_ARGTYPES
        + [ctypes.c_void_p]
    )
    dq, dkv = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
    dq.argtypes = [ctypes.c_void_p] * 8 + common
    dkv.argtypes = [ctypes.c_void_p] * 9 + common
    dq.restype = dkv.restype = ctypes.c_int
    lib.flash_attention_bwd_error.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error.restype = ctypes.c_char_p
    return dq, dkv


def _kernel():
    global _fwd_fn
    if _fwd_fn is None:
        _fwd_fn = bind(_build.load("flash_attention_fwd"))
    return _fwd_fn


def _bwd_kernels():
    global _bwd_fns
    if _bwd_fns is None:
        _bwd_fns = bind_bwd(_build.load("flash_attention_bwd"))
    return _bwd_fns


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = getattr(_build.load(name), f"{name}_error")(err).decode()
        raise DeviceError(f"{name} launch failed: {msg} ({err})")


def _on_card(q: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    return True


def flash_attention_fwd(q, k, v, lengths=None, dropout_rate=0.0, seed=None, return_lse=False,
                        coords: Coords = (0, 0, 0)):
    """(o, lse or None): the forward kernel on a CUDA tensor (counted in
    ``flash_attention.launches``), the plain version on a CPU tensor.
    ``coords``: the dropout hash's global coordinates."""
    _check_dropout(dropout_rate, seed)
    if not _on_card(q, "flash_attention"):
        out = flash_attention_plain(q, k, v, lengths, dropout_rate, seed, return_lse, coords)
        return out if return_lse else (out, None)
    _check_kernel_inputs(q=q, k=k, v=v)
    b, t, h, d = q.shape
    lens = _int32_lengths(lengths, b, q.device)  # the kernel clamps to [0, T]
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if return_lse else None
    if o.numel() == 0:
        return o, lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if lens is None else lens.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            b, t, h,
            float(_scale(d, q.dtype)), _DTYPE_CODES[q.dtype],
            *_dropout_args(dropout_rate, seed, coords, h),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return o, lse


def _bwd_launch(which: int, q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords):
    """Launch the dq (``which`` 0) or dk/dv (1) kernel; returns its outputs."""
    _check_dropout(dropout_rate, seed)
    _check_kernel_inputs(q=q, k=k, v=v, do=do)
    b, t, h, d = q.shape
    _check_row_stats(b, h, t, q.device, lse=lse, delta=delta)
    lens = _int32_lengths(lengths, b, q.device)
    outs = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
            for _ in range(1 + which)]
    if q.numel() == 0:
        return outs
    fn = _bwd_kernels()[which]
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
            None if lens is None else lens.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            b, t, h,
            float(_scale(d, q.dtype)), _DTYPE_CODES[q.dtype],
            *_dropout_args(dropout_rate, seed, coords, h),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_attention_bwd")
    return outs


def flash_attention_bwd_dq(
    q, k, v, do, lse, delta, lengths=None, dropout_rate=0.0, seed=None, coords: Coords = (0, 0, 0)
) -> torch.Tensor:
    """dq of suffix-masked attention (``[B, T, H, D]``, the input type): the
    dq kernel on a CUDA tensor (counted in ``.launches``), the plain version
    on a CPU tensor."""
    if not _on_card(q, "flash_attention_bwd_dq"):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)[0]
    (dq,) = _bwd_launch(0, q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(
    q, k, v, do, lse, delta, lengths=None, dropout_rate=0.0, seed=None, coords: Coords = (0, 0, 0)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of suffix-masked attention: the dk/dv kernel on a CUDA
    tensor (counted in ``.launches``), the plain version on a CPU tensor."""
    if not _on_card(q, "flash_attention_bwd_dkv"):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)[1:]
    dk, dv = _bwd_launch(1, q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) as a contiguous f32 [B, H, T] (left to PyTorch,
    as the JAX package leaves it to XLA, :732-737)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, o, do, lse, lengths=None, dropout_rate=0.0, seed=None,
                        coords: Coords = (0, 0, 0)):
    """(dq, dk, dv) from the forward's inputs, output and LSE and the
    output's gradient: both kernels on a CUDA tensor, one plain pass on a
    CPU tensor."""
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or do.data_ptr() % 16:
        do = do.contiguous()
    delta = attention_delta(o, do)
    if not _on_card(q, "flash_attention_bwd"):
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, lengths, dropout_rate, seed, coords)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable suffix-masked attention with in-kernel dropout (the
    ``_flash_attention`` custom_vjp, :697-755). The forward saves q, k, v,
    o, the LSE and the lengths, seed and rate; the backward recomputes P
    tile by tile and regenerates the keep mask. q, k and v stay separate
    inputs (views of the fused projection), so the split's backward
    concatenates their three gradients."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, seed, dropout_rate, coords=(0, 0, 0)):
        o, lse = flash_attention_fwd(q, k, v, lengths, dropout_rate, seed, return_lse=True, coords=coords)
        ctx.save_for_backward(q, k, v, o, lse, lengths)
        ctx.seed, ctx.dropout_rate, ctx.coords = seed, dropout_rate, coords
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, do, lse, lengths, ctx.dropout_rate, ctx.seed, ctx.coords
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # [B] int suffix lengths
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    coords: Coords = (0, 0, 0),
) -> torch.Tensor:
    """Suffix-masked attention, ``[B, T, H, D]`` in and out, with dropout
    on the post-softmax P at ``dropout_rate`` from the int32 ``seed``;
    ``coords`` = (row0, head0, heads) places the call's rows and heads in
    the global batch whose mask it draws (``attention_dropout_keep``).

    With grad enabled for q, k or v, or a rate above 0, the call goes
    through ``FlashAttentionFunction``; otherwise it is the inference
    forward (no LSE). A CUDA tensor launches the kernels (each counted in
    its wrapper's ``.launches``: ``flash_attention.launches`` for the
    forward) or raises; a CPU tensor runs the plain versions.
    """
    _check_dropout(dropout_rate, seed)
    needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if needs_grad or dropout_rate > 0.0:
        return FlashAttentionFunction.apply(q, k, v, lengths, seed, float(dropout_rate), tuple(coords))
    return flash_attention_fwd(q, k, v, lengths, 0.0, None, return_lse=False)[0]


flash_attention.launches = 0
