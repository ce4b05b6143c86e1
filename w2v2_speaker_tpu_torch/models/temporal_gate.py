"""Temporal gating (a learned per-frame gate) of wav2spk.

Counterpart of ``w2v2_speaker_tpu/models/temporal_gate.py::TemporalGate``
(:20): sigmoid(W x_t + b) times x_t. ``W`` is applied as
``einsum("btf,gf->btg")``, so it is ``[out, in]`` as stored in the flax
tree and is carried across untransposed; it is square, so only an output
comparison tells a transposed ``W`` apart. The input here is
channels-first ``[B, F, T]``. ``init_parameters`` draws ``W``
xavier-normal and ``b`` normal with std sqrt(2 / (F + 1)), as the flax
initialisers do.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["TemporalGate"]


class TemporalGate(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(features, features))
        self.b = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, F, T]
        return torch.sigmoid(torch.matmul(self.W, x) + self.b[:, None]) * x
