"""FC prediction head.

Counterpart of ``w2v2_speaker_tpu/models/heads.py::FCHead`` (:65): one
(Linear -> ReLU) block per hidden size, then a plain Linear to ``num_out``;
the speaker embedding is the output of block ``embedding_layer_idx`` (-1 =
the pooled input itself, ``len(hidden_sizes)`` = the logits). The AAM head
(``AAMSoftmaxHead`` :29) comes with slice 2 (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FCHead"]


class FCHead(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int],
        num_out: int,
        embedding_layer_idx: int = -1,
    ):
        super().__init__()
        self.embedding_layer_idx = embedding_layer_idx
        self.num_hidden = len(hidden_sizes)
        for i, size in enumerate(hidden_sizes):
            self.add_module(f"fc_{i}", nn.Linear(in_features, size))
            in_features = size
        self.fc_out = nn.Linear(in_features, num_out)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(embedding, logits)."""
        embedding = h = x
        for i in range(self.num_hidden):
            h = F.relu(getattr(self, f"fc_{i}")(h))
            if i == self.embedding_layer_idx:
                embedding = h
        logits = self.fc_out(h)
        if self.embedding_layer_idx == self.num_hidden:
            embedding = logits
        return embedding, logits
