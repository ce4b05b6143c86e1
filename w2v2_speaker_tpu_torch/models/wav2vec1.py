"""wav2vec v1 (Schneider et al. 2019) as a frame embedder, with two speaker
heads: the port's copy of ``w2v2_speaker_tpu/models/wav2vec1.py``.

- ``Wav2Vec1Config`` (:50);
- ``SampleNorm`` (:67, fairseq's Fp32GroupNorm(1, C)): per row over (T, C)
  in float32, over the valid frames of a frame mask (their count times C,
  clamped at 1), biased variance, eps 1e-5, the output in the input's type;
- ``Wav2Vec1Encoder`` (:93): raw waveform ``[B, N]`` -> (float32 features
  ``[B, T, 512]``, frame mask ``[B, T]`` or None): the strided convs
  ``fe_conv_{0..4}`` (512 x k10 s5, k8 s4, then three k4 s2; no padding),
  each followed by ``fe_norm_i`` and ReLU, the frames past a row's length
  zeroed after every ReLU; ``log(1 + |x|)`` compression; with
  ``use_aggregator`` nine k3 convs ``agg_conv_i`` (same padding) over the
  masked input, each with ``agg_norm_i``, ReLU and a residual;
- ``Wav2Vec1FCModel`` (:171): mean or mean+std pooling (any other
  ``stat_pooling_type`` raises ``ValueError``) and the ``FCHead``;
- ``Wav2Vec1XVectorModel`` (:211): the x-vector network of
  ``models/xvector.py`` over the 512 features and their frame mask.

The convs run channels-first (``[B, C, T]``). Parameters are float32 and
keep the flax names (``encoder.fe_conv_0``, ``head.backbone.tdnn_0``), so
``convert.params_from_jax`` loads the JAX trees strictly; the top-level
``encoder`` is what ``wav2vec_initially_frozen`` freezes, as in the JAX
package. With ``dtype`` bfloat16 the encoder runs under autocast, as the
flax convs compute in bfloat16: norm statistics and the logarithm in
float32, each rounded to bfloat16 where the JAX module rounds; the heads
compute in float32, as the JAX package builds them (a float64 copy of the
model computes in float64 throughout). The convolutions are
library calls, as they are XLA (not Pallas) in the JAX package. The
feature-encoder dropout of the config (``dropout``, which no recipe sets)
raises when it is not 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .heads import FCHead
from .pooling import MeanPool, MeanStdPool
from .wav2vec2 import _compute_context
from .xvector import XVectorConfig, XVectorModel

__all__ = ["SampleNorm", "Wav2Vec1Config", "Wav2Vec1Encoder", "Wav2Vec1FCModel", "Wav2Vec1XVectorModel"]


@dataclass(frozen=True)
class Wav2Vec1Config:
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 8, 4),
        (512, 4, 2),
        (512, 4, 2),
        (512, 4, 2),
    )
    agg_layers: int = 9
    agg_kernel: int = 3
    agg_dim: int = 512
    dropout: float = 0.0
    log_compression: bool = True
    skip_connections_agg: bool = True
    use_aggregator: bool = False
    dtype: str = "float32"


class SampleNorm(nn.Module):
    """GroupNorm(1) of ``[B, C, T]`` over (C, T) per row, over the valid
    frames of ``mask`` ``[B, T]`` (None: all)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            if mask is None:
                mean = x32.mean(dim=(1, 2), keepdim=True)
                var = x32.var(dim=(1, 2), keepdim=True, unbiased=False)
            else:
                m = mask.to(x32.dtype)[:, None, :]
                n = (m.sum(dim=(1, 2), keepdim=True) * x.shape[1]).clamp_min(1.0)
                mean = (x32 * m).sum(dim=(1, 2), keepdim=True) / n
                var = ((x32 - mean) ** 2 * m).sum(dim=(1, 2), keepdim=True) / n
            y = (x32 - mean) * torch.rsqrt(var + 1e-5)
            y = y * self.weight.to(x32.dtype)[:, None] + self.bias.to(x32.dtype)[:, None]
        return y.to(x.dtype)


def _zero_past(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else x * mask.to(x.dtype)[:, None, :]


class Wav2Vec1Encoder(nn.Module):
    """Raw waveform ``[B, N]`` -> (float32 features ``[B, T, F]``, frame
    mask ``[B, T]`` or None); F is 512."""

    def __init__(self, cfg: Wav2Vec1Config = Wav2Vec1Config()):
        super().__init__()
        if cfg.dropout:
            raise NotImplementedError("Wav2Vec1Config.dropout > 0: no recipe sets it, and it is not ported")
        self.cfg = cfg
        c_in = 1
        for i, (c, k, s) in enumerate(cfg.conv_layers):
            self.add_module(f"fe_conv_{i}", nn.Conv1d(c_in, c, k, stride=s))
            self.add_module(f"fe_norm_{i}", SampleNorm(c))
            c_in = c
        if cfg.use_aggregator:
            for i in range(cfg.agg_layers):
                self.add_module(f"agg_conv_{i}", nn.Conv1d(c_in, cfg.agg_dim, cfg.agg_kernel,
                                                           padding=cfg.agg_kernel // 2))
                self.add_module(f"agg_norm_{i}", SampleNorm(cfg.agg_dim))
                c_in = cfg.agg_dim

    @property
    def num_features(self) -> int:
        return self.cfg.agg_dim if self.cfg.use_aggregator else self.cfg.conv_layers[-1][0]

    def forward(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        param_dtype = self.fe_conv_0.weight.dtype
        x = wav.to(param_dtype)[:, None, :]
        cur_len = None if wav_mask is None else wav_mask.sum(dim=-1)

        def frame_mask(t: int) -> Optional[torch.Tensor]:
            if cur_len is None:
                return None
            return torch.arange(t, device=x.device)[None, :] < cur_len[:, None]

        compute = getattr(torch, cfg.dtype) if param_dtype == torch.float32 else param_dtype  # a float64 copy
        with _compute_context(wav.device, compute, param_dtype):
            for i, (_, k, s) in enumerate(cfg.conv_layers):
                x = getattr(self, f"fe_conv_{i}")(x)
                if cur_len is not None:
                    cur_len = (cur_len - k) // s + 1
                fm = frame_mask(x.shape[2])
                x = _zero_past(F.relu(getattr(self, f"fe_norm_{i}")(x, fm)), fm)
            if cfg.log_compression:  # 1 + |x| rounded to the compute type, the log in float32
                x = torch.log((1.0 + x.abs()).to(torch.promote_types(x.dtype, torch.float32))).to(x.dtype)
            fm = frame_mask(x.shape[2])
            if cfg.use_aggregator:
                for i in range(cfg.agg_layers):
                    y = getattr(self, f"agg_conv_{i}")(_zero_past(x, fm))
                    y = F.relu(getattr(self, f"agg_norm_{i}")(y, fm))
                    x = y + x if cfg.skip_connections_agg else y
                x = _zero_past(x, fm)
        return x.transpose(1, 2).to(param_dtype), fm


class Wav2Vec1FCModel(nn.Module):
    """wav2vec v1 features -> mean or mean+std pooling -> ``FCHead``. The
    model contract of ``SpeakerTask``: ``generator`` and ``labels`` are
    accepted and not read."""

    def __init__(self, cfg: Wav2Vec1Config = Wav2Vec1Config(), stat_pooling_type: str = "mean",
                 hidden_fc_layers_out: Tuple[int, ...] = (), embedding_layer_idx: int = -1,
                 num_speakers: int = 100):
        super().__init__()
        self.cfg = cfg
        if stat_pooling_type == "mean":
            self.stat_pooling, factor = MeanPool(), 1
        elif stat_pooling_type == "mean+std":
            self.stat_pooling, factor = MeanStdPool(), 2
        else:
            raise ValueError("wav2vec v1 FC supports 'mean' and 'mean+std' pooling")
        self.encoder = Wav2Vec1Encoder(cfg)
        self.head = FCHead(factor * self.encoder.num_features, tuple(hidden_fc_layers_out), num_speakers,
                           embedding_layer_idx)

    def forward(self, wav, wav_mask=None, train: bool = False, generator=None, labels=None) -> Dict[str, torch.Tensor]:
        features, frame_mask = self.encoder(wav, wav_mask)
        embedding, logits = self.head(self.stat_pooling(features, frame_mask))
        return {"embedding": embedding, "logits": logits}

    def compute_embedding(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward(wav, wav_mask)["embedding"]


class Wav2Vec1XVectorModel(nn.Module):
    """wav2vec v1 features -> the x-vector network (``XVectorModel`` of
    ``xvector``, whose ``in_channels`` is the encoder's 512)."""

    def __init__(self, cfg: Wav2Vec1Config = Wav2Vec1Config(),
                 xvector: XVectorConfig = XVectorConfig(in_channels=512), num_speakers: int = 100):
        super().__init__()
        self.cfg = cfg
        self.encoder = Wav2Vec1Encoder(cfg)
        self.head = XVectorModel(xvector, num_speakers)

    def forward(self, wav, wav_mask=None, train: bool = False, generator=None, labels=None) -> Dict[str, torch.Tensor]:
        features, frame_mask = self.encoder(wav, wav_mask)
        return self.head(features, frame_mask, train=train)

    def compute_embedding(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        features, frame_mask = self.encoder(wav, wav_mask)
        return self.head.compute_embedding(features, frame_mask)
