"""wav2vec2 + pooling + FC head speaker model, eval and training.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2_speaker.py``:
``Wav2Vec2SpeakerConfig`` (:44) and ``Wav2Vec2SpeakerModel`` (:62) with its
pooling setup (:66-84), train and eval forward (:108-156) and
``compute_embedding`` (:158). The backbone computes in ``cfg.w2v2.dtype``
and returns float32 features; pooling and the heads run in float32, as the
JAX package's do. Training pools with ``stat_pooling_type``, eval with
``test_stat_pooling_type`` (the same module when the names agree, so an
attentive pooling serves with what it learned); ``first+cls`` has the
backbone insert a CLS row and pools it. With ``use_aam`` the FC head has no
output layer and the ``AAMSoftmaxHead`` ``aam`` (:97-103) takes the
embedding: given labels, the forward also returns its ``loss`` and
``preds`` (:147-156).

The frame-level path (:119-131, the ``ce_no_pool`` and ``speaker_ctc``
modes): with ``stat_pooling_type`` ``none``, in training or where the test
pooling is ``none`` too, the head runs on every frame and the forward
returns ``[B, T, ...]`` embeddings and logits with the ``frame_mask``.
``ctc_head`` adds the blank as class 0 (``num_speakers + 1`` outputs,
:89) and ``ctc_blank_bias`` starts its bias high. In training,
``final_channel_mask_prob`` zeroes whole channels of the pooled embedding
(``embedding_mask``, :134-142), drawn from the step's generator.

``feature_encoder_only`` (:68-71) takes ``Wav2Vec2LiteEncoder`` as the
backbone: the conv stack's 512 float32 features are pooled, with no
transformer. ``compute_ensemble_embeddings`` (:163-181) pools the last
``num_ensembles`` of the backbone's hidden states, each with the training
pooling, for layer-ensemble scoring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .heads import AAMSoftmaxHead, FCHead
from .masking import embedding_mask
from .pooling import get_pooling, pooled_embedding_size
from .wav2vec2 import BASE_CONFIG, Wav2Vec2Config, Wav2Vec2LiteEncoder, Wav2Vec2Model

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
        self.cfg = cfg
        if cfg.feature_encoder_only:
            self.wav2vec2 = Wav2Vec2LiteEncoder(cfg.w2v2)
            feat = cfg.w2v2.conv_dim[-1]
        else:
            self.wav2vec2 = Wav2Vec2Model(cfg.w2v2, insert_cls_token=cfg.stat_pooling_type == "first+cls")
            feat = cfg.w2v2.hidden_size
        self.stat_pooling = get_pooling(cfg.stat_pooling_type, feat)
        test_type = cfg.test_stat_pooling_type or cfg.stat_pooling_type
        if test_type == "attentive" and cfg.stat_pooling_type != "attentive":
            raise ValueError("attention can not be learned at test time")
        # a distinct test pooling is a module of its own; the same name
        # pools with the training module
        self.test_stat_pooling = (
            get_pooling(test_type, feat) if test_type != cfg.stat_pooling_type else None
        )
        self.pool_dim = pooled_embedding_size(cfg.stat_pooling_type, feat)
        self.head = FCHead(
            self.pool_dim,
            cfg.hidden_fc_layers_out,
            num_speakers + (1 if cfg.ctc_head else 0),
            cfg.embedding_layer_idx,
            use_aam=cfg.use_aam,
            ctc_blank_bias=cfg.ctc_blank_bias,
        )
        if cfg.use_aam:
            sizes = (self.pool_dim, *cfg.hidden_fc_layers_out)
            idx = cfg.embedding_layer_idx
            emb_dim = sizes[idx + 1] if -1 <= idx < len(sizes) - 1 else self.pool_dim
            self.aam = AAMSoftmaxHead(emb_dim, num_speakers, cfg.aam_margin, cfg.aam_scale)

    def forward(
        self,
        wav: torch.Tensor,  # [B, N]
        wav_mask: Optional[torch.Tensor] = None,  # [B, N] validity
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        labels: Optional[torch.Tensor] = None,  # [B], read under AAM
    ) -> Dict[str, torch.Tensor]:
        """``{"embedding", "logits"}`` (logits None under AAM), and under
        AAM with ``labels`` also ``loss`` and ``preds``; on the frame-level
        path ``[B, T, ...]`` embeddings and logits and the ``frame_mask``.
        ``train=True`` runs the backbone's regularisation with every draw
        from ``generator``, pools with the train pooling (its BatchNorm on
        batch statistics, ``random`` on a drawn frame) and masks the pooled
        embedding's channels."""
        cfg = self.cfg
        features, frame_mask = self.wav2vec2(wav, wav_mask, train, generator)
        if cfg.stat_pooling_type == "none" and (train or (cfg.test_stat_pooling_type or "none") == "none"):
            embedding, logits = self.head(features)
            return {"embedding": embedding, "logits": logits, "frame_mask": frame_mask}
        pool = self.stat_pooling if train else (self.test_stat_pooling or self.stat_pooling)
        pooled = pool(features, frame_mask, train=train, generator=generator)
        if train and cfg.final_channel_mask_prob > 0:
            pooled = embedding_mask(pooled[:, None, :], 0.0, 1, cfg.final_channel_mask_prob,
                                    cfg.final_channel_mask_width, generator)[:, 0, :]
        embedding, logits = self.head(pooled)
        out = {"embedding": embedding, "logits": logits}
        if self.cfg.use_aam and labels is not None:
            out["loss"], out["preds"] = self.aam(embedding, labels)
        return out

    def compute_embedding(
        self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Deterministic embedding extraction (test-time pooling)."""
        return self.forward(wav, wav_mask)["embedding"]

    def compute_ensemble_embeddings(
        self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None, num_ensembles: int = 12
    ) -> List[torch.Tensor]:
        """The last ``num_ensembles`` of the backbone's hidden states (the
        encoder's input, then each layer's output), each pooled on its
        device with the training pooling: ``num_ensembles`` float32 tensors
        ``[B, D]``."""
        if self.cfg.feature_encoder_only:
            raise ValueError("ensembles need the transformer encoder")
        _, frame_mask, hiddens = self.wav2vec2(wav, wav_mask, output_hidden_states=True)
        return [self.stat_pooling(h, frame_mask, train=False) for h in hiddens[len(hiddens) - num_ensembles:]]
