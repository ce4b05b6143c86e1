"""Classification heads.

Counterpart of ``w2v2_speaker_tpu/models/heads.py``:

- ``AAMSoftmaxHead`` (:29): the angular-additive-margin softmax head,
  owning its ``weights`` ``[num_classes, D]``; with labels it returns (loss,
  softmax predictions) of the margin logits, the loss a mean weighted by
  the optional per-row ``weights`` (0 for padding rows, the multitask
  recipe's), without labels the scaled cosines;
- ``FCHead`` (:65): one (Linear -> ReLU) block per hidden size, then a
  plain Linear to ``num_out``; the speaker embedding is the output of block
  ``embedding_layer_idx`` (-1 = the pooled input itself,
  ``len(hidden_sizes)`` = the logits). With ``use_aam`` the final Linear is
  left out and the logits are None: the AAM head consumes the embedding.
  With ``ctc_blank_bias`` (the speaker-CTC head, :91-97) its
  ``after_init_parameters``, which ``init_parameters`` calls last, sets the
  output bias of class 0, the blank, to that value.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..objectives.losses import aam_margin_logits, cross_entropy

__all__ = ["AAMSoftmaxHead", "FCHead"]


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class AAMSoftmaxHead(nn.Module):
    """The JAX head with its default ``easy_margin`` (False), as the speaker
    and multitask models build it."""

    def __init__(self, in_features: int, num_classes: int, margin: float = 0.2,
                 scale: float = 30.0):
        super().__init__()
        self.margin, self.scale = margin, scale
        self.weights = nn.Parameter(torch.empty(num_classes, in_features))

    def forward(self, embedding: torch.Tensor, labels: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None):
        """``embedding`` [B, D], ``labels`` [B] int, ``weights`` [B] or None.
        With labels: (CE of the margin logits, its mean weighted by
        ``weights``; softmax predictions). Without: the cosines times
        ``scale``."""
        cosine = _unit_rows(embedding.float()) @ _unit_rows(self.weights.float()).T
        if labels is None:
            return cosine * self.scale
        return cross_entropy(aam_margin_logits(cosine, labels, self.margin, self.scale), labels, weights)


class FCHead(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int],
        num_out: int,
        embedding_layer_idx: int = -1,
        use_aam: bool = False,
        ctc_blank_bias: float = 0.0,
    ):
        super().__init__()
        self.embedding_layer_idx = embedding_layer_idx
        self.ctc_blank_bias = ctc_blank_bias
        self.num_hidden = len(hidden_sizes)
        for i, size in enumerate(hidden_sizes):
            self.add_module(f"fc_{i}", nn.Linear(in_features, size))
            in_features = size
        self.fc_out = None if use_aam else nn.Linear(in_features, num_out)

    @torch.no_grad()
    def after_init_parameters(self) -> None:
        if self.ctc_blank_bias and self.fc_out is not None:
            self.fc_out.bias[0] = self.ctc_blank_bias

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(embedding, logits) over the last axis of ``x`` ([B, D] pooled or
        [B, T, D] frames); logits None under AAM."""
        embedding = h = x
        for i in range(self.num_hidden):
            h = F.relu(getattr(self, f"fc_{i}")(h))
            if i == self.embedding_layer_idx:
                embedding = h
        if self.fc_out is None:
            return embedding, None
        logits = self.fc_out(h)
        if self.embedding_layer_idx == self.num_hidden:
            embedding = logits
        return embedding, logits
