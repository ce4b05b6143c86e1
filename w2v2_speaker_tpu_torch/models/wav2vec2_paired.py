"""Paired wav2vec2 speaker-equality model (the paper's w2v2-bce recipe).

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2_paired.py``:
``Wav2Vec2PairedConfig`` (:38) and ``Wav2Vec2PairedModel`` (:45). Both
waveforms pass through one conv feature encoder and one feature
projection; each row is then packed compactly as ``[CLS, f1 valid, SEP,
f2 valid, SEP, 0...]`` (the constants in the compute type) by a gather
over output positions, with the suffix mask ``p <= 2 + t1 + t2`` that the
attention kernels take as one length per row, and runs through one
encoder. The CLS output, cast to float32, feeds ``equality_head``
(Dense hidden -> 1) in float32, outside autocast. No per-row loop and no
host sync: padded batches score as unpadded pairs do.

As in the JAX package there is no SpecAugment and no
``masked_spec_embed``, although the config carries ``mask_time_prob``.
Submodule names are the flax tree's (``feature_encoder``,
``feature_projection``, ``encoder``, ``equality_head``), so
``convert.params_from_jax`` loads a JAX checkpoint with ``strict=True``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .wav2vec2 import (
    BASE_CONFIG, ConvFeatureEncoder, Encoder, FeatureProjection, Wav2Vec2Config, _compute_context,
    feat_extract_output_lengths,
)

__all__ = ["Wav2Vec2PairedConfig", "Wav2Vec2PairedModel"]


@dataclass(frozen=True)
class Wav2Vec2PairedConfig:
    w2v2: Wav2Vec2Config = BASE_CONFIG
    cls_token_constant: float = 1.0
    sep_token_constant: float = -1.0


def _valid_frames(mask: Optional[torch.Tensor], t: int, cfg: Wav2Vec2Config, b: int, device) -> torch.Tensor:
    """[B] valid frame counts of one side (``t`` when ``mask`` is None)."""
    if mask is None:
        return torch.full((b,), t, dtype=torch.long, device=device)
    lengths = feat_extract_output_lengths(mask.sum(-1), cfg)
    return lengths.clamp(0, t).long()


class Wav2Vec2PairedModel(nn.Module):
    def __init__(self, cfg: Wav2Vec2PairedConfig = Wav2Vec2PairedConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = ConvFeatureEncoder(cfg.w2v2)
        self.feature_projection = FeatureProjection(cfg.w2v2)
        self.encoder = Encoder(cfg.w2v2)
        self.equality_head = nn.Linear(cfg.w2v2.hidden_size, 1)

    def pack(self, f1: torch.Tensor, f2: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor):
        """(sequence [B, 3 + T1 + T2, H], mask [B, 3 + T1 + T2]) of the
        projected sides ``f1`` [B, T1, H] and ``f2`` [B, T2, H] with
        ``t1``, ``t2`` [B] valid frames."""
        b, n1, h = f1.shape
        n2 = f2.shape[1]
        total = 3 + n1 + n2
        p = torch.arange(total, device=f1.device)[None, :]
        t1b, t2b = t1[:, None], t2[:, None]
        g1 = f1.gather(1, (p - 1).clamp(0, n1 - 1)[:, :, None].expand(b, total, h))
        g2 = f2.gather(1, (p - 2 - t1b).clamp(0, n2 - 1)[:, :, None].expand(b, total, h))
        cls = torch.tensor(self.cfg.cls_token_constant, dtype=f1.dtype, device=f1.device)
        sep = torch.tensor(self.cfg.sep_token_constant, dtype=f1.dtype, device=f1.device)
        seq = torch.zeros((), dtype=f1.dtype, device=f1.device).expand(b, total, h)
        seq = torch.where((p == 0)[:, :, None], cls, seq)
        seq = torch.where(((p >= 1) & (p < 1 + t1b))[:, :, None], g1, seq)
        seq = torch.where(((p == 1 + t1b) | (p == 2 + t1b + t2b))[:, :, None], sep, seq)
        seq = torch.where(((p >= 2 + t1b) & (p < 2 + t1b + t2b))[:, :, None], g2, seq)
        return seq, p <= 2 + t1b + t2b

    def forward(
        self,
        wav_a: torch.Tensor,  # [B, N1]
        wav_b: torch.Tensor,  # [B, N2]
        mask_a: Optional[torch.Tensor] = None,
        mask_b: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """``{"logit" [B, 1], "cls_embedding" [B, H]}``, both float32.
        ``train=True`` applies dropout and layerdrop with every draw from
        ``generator`` (required then): side a's projection, side b's, then
        the encoder's."""
        if train and generator is None:
            raise ValueError("train=True needs the train step's torch.Generator")
        gen = generator if train else None
        cfg = self.cfg.w2v2
        param_dtype = self.feature_projection.projection.weight.dtype
        with _compute_context(wav_a.device, getattr(torch, cfg.dtype), param_dtype):
            f1 = self.feature_projection(self.feature_encoder(wav_a, mask_a), gen)
            f2 = self.feature_projection(self.feature_encoder(wav_b, mask_b), gen)
            b = f1.shape[0]
            t1 = _valid_frames(mask_a, f1.shape[1], cfg, b, f1.device)
            t2 = _valid_frames(mask_b, f2.shape[1], cfg, b, f2.device)
            seq, seq_mask = self.pack(f1, f2, t1, t2)
            encoded = self.encoder(seq, seq_mask, gen)
        cls_out = encoded[:, 0].float()
        return {"logit": self.equality_head(cls_out), "cls_embedding": cls_out}
