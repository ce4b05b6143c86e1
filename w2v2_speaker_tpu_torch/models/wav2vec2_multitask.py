"""Joint speaker and speech recognition on one wav2vec2 backbone.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2_multitask.py``:
``Wav2Vec2MultitaskConfig`` (:40) and ``Wav2Vec2MultitaskModel`` (:55). One
backbone forward feeds two branches: the speech branch takes the float32
frames through the head dropout and the ``lm_head`` Linear to float32 CTC
logits over the vocabulary; the speaker branch pools the same frames
(``stat_pooling``) and runs the ``FCHead``, whose logits are the speaker
CE's, or, with ``use_aam``, whose embedding the ``AAMSoftmaxHead`` scores
against the labels with per-row ``label_weights`` (0 for padding rows).
``compute_embedding`` is the speaker branch alone, deterministic. The
submodules carry the flax names (``wav2vec2``, ``lm_head``,
``stat_pooling``, ``head``, ``aam``), so ``params_from_jax`` of the JAX
model's params loads with ``strict=True``.

The head dropout draws its mask as the backbone's dropout sites do
(``HashDropout``); the JAX package's is flax's ``nn.Dropout``, so no mask is
bit-equal across the packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .heads import AAMSoftmaxHead, FCHead
from .pooling import get_pooling, pooled_embedding_size
from .wav2vec2 import BASE_CONFIG, HashDropout, Wav2Vec2Config, Wav2Vec2Model

__all__ = ["Wav2Vec2MultitaskConfig", "Wav2Vec2MultitaskModel"]


@dataclass(frozen=True)
class Wav2Vec2MultitaskConfig:
    w2v2: Wav2Vec2Config = BASE_CONFIG
    vocab_size: int = 32
    head_dropout: float = 0.1
    stat_pooling_type: str = "mean"
    hidden_fc_layers_out: Tuple[int, ...] = ()
    embedding_layer_idx: int = -1
    use_aam: bool = False
    aam_margin: float = 0.2
    aam_scale: float = 30.0


class Wav2Vec2MultitaskModel(nn.Module):
    def __init__(self, cfg: Wav2Vec2MultitaskConfig = Wav2Vec2MultitaskConfig(), num_speakers: int = 100):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.w2v2.hidden_size
        self.wav2vec2 = Wav2Vec2Model(cfg.w2v2)
        self.head_dropout = HashDropout(cfg.head_dropout, cfg.w2v2.hash_dropout)
        self.lm_head = nn.Linear(hidden, cfg.vocab_size)
        self.stat_pooling = get_pooling(cfg.stat_pooling_type, hidden)
        pool_dim = pooled_embedding_size(cfg.stat_pooling_type, hidden)
        self.head = FCHead(pool_dim, cfg.hidden_fc_layers_out, num_speakers, cfg.embedding_layer_idx,
                           use_aam=cfg.use_aam)
        if cfg.use_aam:
            sizes = (pool_dim, *cfg.hidden_fc_layers_out)
            idx = cfg.embedding_layer_idx
            emb_dim = sizes[idx + 1] if -1 <= idx < len(sizes) - 1 else pool_dim
            self.aam = AAMSoftmaxHead(emb_dim, num_speakers, cfg.aam_margin, cfg.aam_scale)

    def forward(
        self,
        wav: torch.Tensor,  # [B, N]
        wav_mask: Optional[torch.Tensor] = None,  # [B, N] validity
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        labels: Optional[torch.Tensor] = None,  # [B] speaker labels, read under AAM
        label_weights: Optional[torch.Tensor] = None,  # [B], 0 for padding rows
    ) -> Dict[str, Optional[torch.Tensor]]:
        """``{"ctc_logits"`` [B, T, V] float32, ``"frame_mask"`` [B, T] or
        None, ``"embedding"`` [B, D], ``"logits"`` [B, C] (None under
        AAM)``}``, and under AAM with ``labels`` also ``loss`` and
        ``preds``; ``train=True`` draws every mask from ``generator``."""
        features, frame_mask = self.wav2vec2(wav, wav_mask, train, generator)
        h = self.head_dropout(features, generator if train else None)
        pooled = self.stat_pooling(features, frame_mask, train=train, generator=generator)
        embedding, logits = self.head(pooled)
        out = {"ctc_logits": self.lm_head(h).float(), "frame_mask": frame_mask, "embedding": embedding,
               "logits": logits}
        if self.cfg.use_aam and labels is not None:
            out["loss"], out["preds"] = self.aam(embedding, labels, label_weights)
        return out

    def compute_embedding(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic speaker-embedding extraction."""
        features, frame_mask = self.wav2vec2(wav, wav_mask)
        return self.head(self.stat_pooling(features, frame_mask, train=False))[0]
