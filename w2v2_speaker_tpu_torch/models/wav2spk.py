"""wav2spk: raw-waveform CNN speaker embedder (Lin & Mak, Interspeech 2020).

Counterpart of ``w2v2_speaker_tpu/models/wav2spk.py``: ``Wav2SpkConfig``
(:44), the five-layer encoder ``enc_{0..4}`` with explicit padding (:34,
kernel / stride / padding 10/5/4, 5/4/2, 5/2/2, 3/2/1, 3/2/1; 40, 200,
300, 512, 512 channels), each followed by ``_masked_instance_norm``
(:53: per row and channel over the valid frames, biased variance, the
count clamped at 1, eps 1e-5), ReLU and the frame mask of
``_conv_out_length`` (:66); the ``gate`` (``TemporalGate``), the four
aggregator convs ``agg_{0..3}`` (k3 s1 p1, 512, ReLU, masked); then
``MeanPool`` or ``MeanStdPool`` (any other ``stat_pooling_type`` raises
``ValueError``) and the ``head`` (``FCHead``). Channels-first and in the parameters' type
(float32), as ``models/xvector.py``; the convolutions are library calls,
as they are XLA in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .heads import FCHead
from .pooling import MeanPool, MeanStdPool
from .temporal_gate import TemporalGate

__all__ = ["Wav2SpkConfig", "Wav2SpkModel"]

_ENCODER = (  # (channels, kernel, stride, padding)
    (40, 10, 5, 4),
    (200, 5, 4, 2),
    (300, 5, 2, 2),
    (512, 3, 2, 1),
    (512, 3, 2, 1),
)
_AGGREGATOR = ((512, 3, 1, 1),) * 4


@dataclass(frozen=True)
class Wav2SpkConfig:
    apply_temporal_gating: bool = True
    hidden_fc_layers_out: Tuple[int, ...] = ()
    embedding_layer_idx: int = -1
    stat_pooling_type: str = "mean"  # 'mean' | 'mean+std'


def _masked_instance_norm(x: torch.Tensor, mask: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d of ``[B, C, T]`` over the valid frames of ``mask``
    ``[B, 1, T]`` (None: all)."""
    if mask is None:
        mean = x.mean(dim=2, keepdim=True)
        var = x.var(dim=2, keepdim=True, unbiased=False)
    else:
        n = mask.sum(dim=2, keepdim=True).clamp_min(1.0)
        mean = (x * mask).sum(dim=2, keepdim=True) / n
        var = ((x - mean) ** 2 * mask).sum(dim=2, keepdim=True) / n
    return (x - mean) * torch.rsqrt(var + eps)


def _conv_out_length(n, kernel: int, stride: int, padding: int):
    return (n + 2 * padding - kernel) // stride + 1


class Wav2SpkModel(nn.Module):
    """The model contract of ``SpeakerTask``: ``generator`` and ``labels``
    are accepted and not read."""

    def __init__(self, cfg: Wav2SpkConfig = Wav2SpkConfig(), num_speakers: int = 100):
        super().__init__()
        self.cfg = cfg
        if cfg.stat_pooling_type == "mean":
            self.stat_pooling, pool_dim = MeanPool(), 512
        elif cfg.stat_pooling_type == "mean+std":
            self.stat_pooling, pool_dim = MeanStdPool(), 1024
        else:
            raise ValueError(f"unknown pooling {cfg.stat_pooling_type}; wav2spk supports 'mean' and 'mean+std'")
        c_in = 1
        for i, (c, k, s, p) in enumerate(_ENCODER):
            self.add_module(f"enc_{i}", nn.Conv1d(c_in, c, k, stride=s, padding=p))
            c_in = c
        # the JAX module creates the gate's parameters only where it runs
        self.gate = TemporalGate(512) if cfg.apply_temporal_gating else None
        for i, (c, k, s, p) in enumerate(_AGGREGATOR):
            self.add_module(f"agg_{i}", nn.Conv1d(c_in, c, k, stride=s, padding=p))
            c_in = c
        self.head = FCHead(pool_dim, cfg.hidden_fc_layers_out, num_speakers, cfg.embedding_layer_idx)

    def trunk(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """([B, T, 512] features, [B, T] frame mask or None)."""
        x = wav.to(self.enc_0.weight.dtype)[:, None, :]
        cur_len = None if wav_mask is None else wav_mask.sum(dim=-1)

        def frame_mask(t: int) -> Optional[torch.Tensor]:
            if cur_len is None:
                return None
            return torch.arange(t, device=x.device)[None, :] < cur_len[:, None]

        for i, (_, k, s, p) in enumerate(_ENCODER):
            x = getattr(self, f"enc_{i}")(x)
            if cur_len is not None:
                cur_len = _conv_out_length(cur_len, k, s, p)
            fm = frame_mask(x.shape[2])
            m = None if fm is None else fm.float()[:, None, :]
            x = F.relu(_masked_instance_norm(x, m))
            if m is not None:
                x = x * m
        if self.gate is not None:
            x = self.gate(x)
        for i in range(len(_AGGREGATOR)):
            x = F.relu(getattr(self, f"agg_{i}")(x))
            fm = frame_mask(x.shape[2])
            if fm is not None:
                x = x * fm.float()[:, None, :]
        return x.transpose(1, 2), frame_mask(x.shape[2])

    def forward(self, wav, wav_mask=None, train: bool = False, generator=None, labels=None) -> Dict[str, torch.Tensor]:
        features, fmask = self.trunk(wav, wav_mask)
        embedding, logits = self.head(self.stat_pooling(features, fmask))
        return {"embedding": embedding, "logits": logits}

    def compute_embedding(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward(wav, wav_mask)["embedding"]
