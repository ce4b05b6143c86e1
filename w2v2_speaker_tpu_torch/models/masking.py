"""Training-time masks: SpecAugment-style spans and the embedding masker.

Counterpart of ``w2v2_speaker_tpu/models/masking.py``:
``sample_span_mask`` (:66), ``expand_mask_width`` (:25) and
``embedding_mask`` (:39). The JAX functions draw their uniforms from a PRNG
key; here the caller hands them in or they come from the train step's
``torch.Generator`` (``draw_uniform``), so a test can feed both packages
the same numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel.mesh import active_rows

__all__ = ["draw_row_uniform", "draw_uniform", "embedding_mask", "expand_mask_width", "sample_span_mask"]


def draw_uniform(
    generator: torch.Generator, shape: Sequence[int], device: torch.device
) -> torch.Tensor:
    """Uniforms in [0, 1) drawn on ``generator``'s device (the step's CPU
    generator), then moved to ``device``."""
    return torch.rand(tuple(shape), generator=generator).to(device)


def draw_row_uniform(
    generator: torch.Generator, shape: Sequence[int], device: torch.device
) -> torch.Tensor:
    """``draw_uniform`` of a ``shape`` whose axis 0 is the batch rows: in a
    data-parallel microbatch (``parallel.mesh.active_rows``) drawn at the
    global microbatch's rows, which every rank's generator draws alike,
    and cut to this rank's rows."""
    s = active_rows()
    if s is None:
        return draw_uniform(generator, shape, device)
    return s.take(draw_uniform(generator, (s.total, *tuple(shape)[1:]), device))


def sample_span_mask(
    uniform: torch.Tensor,  # [batch, length] in [0, 1)
    mask_prob: float,
    mask_span: int,
    valid_lengths: Optional[torch.Tensor] = None,  # [batch]
) -> torch.Tensor:
    """bool [batch, length], True at masked positions.

    A position starts a span where its uniform is < mask_prob / mask_span
    (only positions where a whole span fits inside the valid length may
    start one), and each start is widened to ``mask_span`` positions to
    the right.
    """
    batch, length = uniform.shape
    if mask_prob <= 0:
        return torch.zeros((batch, length), dtype=torch.bool, device=uniform.device)
    starts = uniform < mask_prob / mask_span
    if valid_lengths is not None:
        pos = torch.arange(length, device=uniform.device)[None, :]
        starts = starts & (pos < valid_lengths[:, None] - mask_span + 1)
    mask = starts
    for k in range(1, min(mask_span, length)):
        mask = mask | F.pad(starts[:, : length - k], (k, 0))
    return mask


def expand_mask_width(dropped: torch.Tensor, width: int) -> torch.Tensor:
    """Each True of the bool vector ``dropped`` widened to ``width``
    consecutive indices to its right (cut at the end)."""
    out = dropped
    for k in range(1, min(width, dropped.shape[0])):
        out = out | F.pad(dropped[: dropped.shape[0] - k], (k, 0))
    return out


def embedding_mask(
    x: torch.Tensor,  # [B, T, C]
    timestep_mask_prob: float,
    timestep_mask_width: int,
    channel_mask_prob: float,
    channel_mask_width: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> torch.Tensor:
    """``x`` with whole time steps and whole channels zeroed, one mask for
    the batch: step t (channel c) is dropped where its uniform is <= its
    probability, and each drop is widened by ``expand_mask_width``. The
    uniforms ([T] for time, [C] for channels, each only where its
    probability is > 0) are ``uniforms`` or drawn from ``generator``,
    time first. Training only: the caller gates it."""
    if x.ndim != 3:
        raise ValueError(f"expected [batch, time, channels], got {tuple(x.shape)}")
    if timestep_mask_prob + channel_mask_prob == 0:
        return x
    _, t, c = x.shape
    t_u, c_u = uniforms if uniforms is not None else (None, None)
    keep = torch.ones((t, c), dtype=x.dtype, device=x.device)
    if timestep_mask_prob > 0:
        t_u = draw_uniform(generator, (t,), x.device) if t_u is None else t_u.to(x.device)
        keep = keep * (~expand_mask_width(t_u <= timestep_mask_prob, timestep_mask_width)).to(x.dtype)[:, None]
    if channel_mask_prob > 0:
        c_u = draw_uniform(generator, (c,), x.device) if c_u is None else c_u.to(x.device)
        keep = keep * (~expand_mask_width(c_u <= channel_mask_prob, channel_mask_width)).to(x.dtype)[None, :]
    return x * keep[None]
