"""Training losses.

Counterpart of ``w2v2_speaker_tpu/objectives/losses.py``: ``cross_entropy``
(:43), ``binary_cross_entropy`` (:63), ``aam_margin_logits`` (:74) and
``ctc_loss`` (:176). The triplet losses are not ported yet (ROADMAP Queue 1
item 7).

``ctc_loss`` keeps the ``zero_infinity`` semantics that the JAX function's
docstring and the original PyTorch reference promise: a row whose frames
are too few for its label scores 0 and gives no gradient. The JAX package
computes CTC with optax, whose finite ``log_epsilon`` (-1e5) scores such a
row ~1e5 instead, so its ``isfinite`` test (:199) never fires and the row
adds ~1e5 / L to the mean: the one deliberate divergence of the two, pinned
by ``tests/test_torch_speech.py``. Feasible rows agree.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["aam_margin_logits", "binary_cross_entropy", "cross_entropy", "ctc_loss", "frame_lengths"]


def cross_entropy(
    logits: torch.Tensor,  # [B, C]
    labels: torch.Tensor,  # [B] int
    weights: Optional[torch.Tensor] = None,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over the batch, softmax predictions without gradient).

    Optional per-row ``weights`` (0 for padding rows, 1 otherwise) turn the
    mean into a weighted mean over max(sum of weights, 1)."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if weights is None:
        loss = ce.mean()
    else:
        w = weights.to(ce.dtype)
        loss = (ce * w).sum() / w.sum().clamp_min(1.0)
    return loss, torch.softmax(logits.detach().float(), dim=-1)


def binary_cross_entropy(
    logits: torch.Tensor,  # [B] or [B, 1]
    labels: torch.Tensor,  # [B] 0 / 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean BCE-with-logits in float32, sigmoid predictions without
    gradient)."""
    logits = logits.reshape(-1).float()
    loss = F.binary_cross_entropy_with_logits(logits, labels.reshape(-1).float())
    return loss, torch.sigmoid(logits.detach())


def aam_margin_logits(
    cosine: torch.Tensor,  # [B, C] cos(theta)
    labels: torch.Tensor,  # [B] int
    margin: float = 0.2,
    scale: float = 30.0,
    easy_margin: bool = False,
) -> torch.Tensor:
    """The target class's cosine replaced by cos(theta + m) inside the
    monotonic region (cos theta > cos(pi - m)) and by cos theta -
    m sin(pi - m) outside it (by cos theta where cos theta <= 0 with
    ``easy_margin``); every logit times ``scale``."""
    sine = (1.0 - cosine * cosine).clamp(0.0, 1.0).sqrt()
    phi = cosine * math.cos(margin) - sine * math.sin(margin)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine - math.cos(math.pi - margin) > 0, phi,
                          cosine - math.sin(math.pi - margin) * margin)
    one_hot = F.one_hot(labels.long(), cosine.shape[-1]).to(cosine.dtype)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * scale


def frame_lengths(logits: torch.Tensor, frame_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The valid frames [B] int32 of frame logits [B, T, ...]: the sum of
    the model's ``frame_mask`` [B, T], or T in every row when it is None."""
    if frame_mask is None:
        return torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int32, device=logits.device)
    return frame_mask.sum(-1).to(torch.int32)


def ctc_loss(
    logits: torch.Tensor,  # [B, T, V]
    logit_lengths: torch.Tensor,  # [B]
    labels: torch.Tensor,  # [B, S], 0-padded
    label_lengths: torch.Tensor,  # [B]
    blank_id: int = 0,
) -> torch.Tensor:
    """Mean over rows with a non-empty label of each row's CTC loss (float32
    log-softmax, infeasible rows 0) divided by its label length; rows with
    an empty label (padding rows) are left out of the mean."""
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # [T, B, V]
    per_seq = F.ctc_loss(log_probs, labels.long(), logit_lengths.long(), label_lengths.long(),
                         blank=blank_id, reduction="none", zero_infinity=True)
    valid = (label_lengths > 0).to(per_seq.dtype)
    per_seq = per_seq / label_lengths.clamp_min(1).to(per_seq.dtype) * valid
    return per_seq.sum() / valid.sum().clamp_min(1.0)
