"""Training losses.

Counterpart of ``w2v2_speaker_tpu/objectives/losses.py``: ``cross_entropy``
(:43), ``binary_cross_entropy`` (:63) and ``aam_margin_logits`` (:74).
The triplet and CTC losses are not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["aam_margin_logits", "binary_cross_entropy", "cross_entropy"]


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
