"""SpecAugment-style span masks.

Counterpart of ``w2v2_speaker_tpu/models/masking.py::sample_span_mask``
(:66). The JAX function draws its uniforms from a PRNG key; here the caller
hands them in (``draw_uniform`` takes them from the train step's
``torch.Generator``), so a test can feed both packages the same numbers.
``embedding_mask`` (:39) is not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["draw_uniform", "sample_span_mask"]


def draw_uniform(
    generator: torch.Generator, shape: Sequence[int], device: torch.device
) -> torch.Tensor:
    """Uniforms in [0, 1) drawn on ``generator``'s device (the step's CPU
    generator), then moved to ``device``."""
    return torch.rand(tuple(shape), generator=generator).to(device)


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
