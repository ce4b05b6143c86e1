"""Training losses.

Counterpart of ``w2v2_speaker_tpu/objectives/losses.py``: ``cross_entropy``
(:43). The other losses (binary CE, AAM margin, triplet, CTC) are not
ported yet (ROADMAP Queue 1 items 3, 5 and 9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy"]


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
