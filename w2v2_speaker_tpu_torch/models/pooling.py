"""Masked pooling ``[B, T, F] -> [B, F']``.

Counterpart of ``w2v2_speaker_tpu/models/pooling.py``: ``MeanPool`` (:75),
``get_pooling`` (:236) and ``pooled_embedding_size`` (:244). Only ``"mean"``
is ported; the other pooling types of the JAX package raise
``NotImplementedError`` until a later slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["MeanPool", "get_pooling", "pooled_embedding_size"]

_NOT_YET = (
    "mean+std", "quantile", "max", "attentive", "first", "first+cls",
    "middle", "last", "random", "none",
)


class MeanPool(nn.Module):
    """Mean over valid frames; an all-invalid row pools to 0."""

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if mask is None:
            return x.mean(dim=1)
        m = mask.to(x.dtype)[:, :, None]
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def _check(name: str) -> None:
    if name in _NOT_YET:
        raise NotImplementedError(
            f"pooling '{name}' is not ported yet (only 'mean'): ROADMAP.md "
            f"Queue 1 item 5"
        )
    if name != "mean":
        raise ValueError(f"unknown pooling '{name}'")


def get_pooling(name: str) -> nn.Module:
    _check(name)
    return MeanPool()


def pooled_embedding_size(name: str, feature_size: int) -> int:
    """Output feature count of a pooling op given its input feature count."""
    _check(name)
    return feature_size
