"""wav2vec2 + pooling + FC head speaker model, eval only.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2_speaker.py``:
``Wav2Vec2SpeakerConfig`` (:44) and ``Wav2Vec2SpeakerModel`` (:62) with
``compute_embedding`` (:158). The backbone computes in ``cfg.w2v2.dtype``
and returns float32 features; pooling and the head run in float32, as the
JAX package's do.

Not ported yet, and raising ``NotImplementedError``: the feature-encoder-only
variant, the AAM head, the CTC head, the frame-level (no-pool) modes,
training and layer-ensemble embeddings (ROADMAP Queue 1 items 3, 5 and 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .heads import FCHead
from .pooling import get_pooling, pooled_embedding_size
from .wav2vec2 import BASE_CONFIG, TRAINING_ROW, Wav2Vec2Config, Wav2Vec2Model

__all__ = ["Wav2Vec2SpeakerConfig", "Wav2Vec2SpeakerModel"]


@dataclass(frozen=True)
class Wav2Vec2SpeakerConfig:
    w2v2: Wav2Vec2Config = BASE_CONFIG
    feature_encoder_only: bool = False
    stat_pooling_type: str = "mean"
    test_stat_pooling_type: Optional[str] = None  # None = same as train
    hidden_fc_layers_out: Tuple[int, ...] = ()
    embedding_layer_idx: int = -1
    use_aam: bool = False
    aam_margin: float = 0.2
    aam_scale: float = 30.0
    final_channel_mask_prob: float = 0.0  # training only
    final_channel_mask_width: int = 1
    ctc_blank_bias: float = 0.0
    ctc_head: bool = False


class Wav2Vec2SpeakerModel(nn.Module):
    def __init__(
        self,
        cfg: Wav2Vec2SpeakerConfig = Wav2Vec2SpeakerConfig(),
        num_speakers: int = 100,
    ):
        super().__init__()
        for name, row in (
            ("feature_encoder_only", "Queue 1 item 2"),
            ("use_aam", "Queue 1 item 3"),
            ("ctc_head", "Queue 1 item 9"),
        ):
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"Wav2Vec2SpeakerConfig.{name}=True is not ported yet: "
                    f"ROADMAP.md {row}"
                )
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg.w2v2)
        self.test_stat_pooling = get_pooling(
            cfg.test_stat_pooling_type or cfg.stat_pooling_type
        )
        self.pool_dim = pooled_embedding_size(
            cfg.stat_pooling_type, cfg.w2v2.hidden_size
        )
        self.head = FCHead(
            self.pool_dim,
            cfg.hidden_fc_layers_out,
            num_speakers,
            cfg.embedding_layer_idx,
        )

    def forward(
        self,
        wav: torch.Tensor,  # [B, N]
        wav_mask: Optional[torch.Tensor] = None,  # [B, N] validity
        train: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Eval forward: ``{"embedding", "logits"}``."""
        if train:
            raise NotImplementedError(f"train=True is not ported yet: {TRAINING_ROW}")
        features, frame_mask = self.wav2vec2(wav, wav_mask)
        embedding, logits = self.head(self.test_stat_pooling(features, frame_mask))
        return {"embedding": embedding, "logits": logits}

    def compute_embedding(
        self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Deterministic embedding extraction (test-time pooling)."""
        return self.forward(wav, wav_mask)["embedding"]
