"""ECAPA-TDNN speaker embedding network (Desplanques et al. 2020).

Counterpart of ``w2v2_speaker_tpu/models/ecapa.py``: ``EcapaConfig``
(:36), ``_TDNNBlock`` (:50), ``_Res2NetBlock`` (:80: ``scale`` channel
groups, group 0 passed through, group i through ``block_{i-1}`` on
x_i + y_{i-1}), ``_SEBlock`` (:109: squeeze-excitation over the masked
time mean, the count clamped at 1), ``_SERes2NetBlock`` (:133), ``EcapaTdnn``
(:162: ``tdnn_0``, ``se_res2net_{0,1,2}``, ``mfa`` over the concatenated
block outputs, ``asp`` attentive statistics pooling, ``asp_bn``, ``fc``)
and ``EcapaModel`` (:224: under AAM the ``aam`` head on the embedding and
no classifier, else a ``classifier`` dense layer).

``_TDNNBlock`` zeroes the padding frames only before a conv with
``kernel_size`` > 1, as the JAX package does, where x-vector masks before
every block: training ``BatchNorm`` takes its statistics over the padding
frames too, so the rule fixes what those frames hold and, through the
statistics, the valid outputs. Channels-first and in the parameters' type,
as ``models/xvector.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .heads import AAMSoftmaxHead
from .pooling import AttentiveStatPool, BatchNorm
from .xvector import TDNNBlock

__all__ = ["EcapaConfig", "EcapaModel", "EcapaTdnn"]


@dataclass(frozen=True)
class EcapaConfig:
    in_channels: int = 80
    channels: Tuple[int, ...] = (1024, 1024, 1024, 1024, 3072)
    kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True
    lin_neurons: int = 192  # embedding size


class _TDNNBlock(TDNNBlock):
    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        if mask is not None and self.conv.kernel_size[0] > 1:
            x = x * mask
        return super().forward(x, train)


class _Res2NetBlock(nn.Module):
    def __init__(self, channels: int, scale: int, kernel_size: int, dilation: int):
        super().__init__()
        self.scale = scale
        width = channels // scale
        for i in range(1, scale):
            self.add_module(f"block_{i - 1}", _TDNNBlock(width, width, kernel_size, dilation))

    def forward(self, x, mask=None, train: bool = False):
        xs = x.chunk(self.scale, dim=1)
        ys, prev = [xs[0]], None
        for i in range(1, self.scale):
            prev = getattr(self, f"block_{i - 1}")(xs[i] if prev is None else xs[i] + prev, mask, train)
            ys.append(prev)
        return torch.cat(ys, dim=1)


class _SEBlock(nn.Module):
    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, se_channels)
        self.fc2 = nn.Linear(se_channels, channels)

    def forward(self, x, mask=None):
        if mask is None:
            s = x.mean(dim=2)
        else:
            s = (x * mask).sum(dim=2) / mask.sum(dim=2).clamp_min(1.0)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s[:, :, None]


class _SERes2NetBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, kernel_size: int, dilation: int, scale: int,
                 se_channels: int):
        super().__init__()
        self.tdnn_in = _TDNNBlock(in_channels, channels, 1)
        self.res2net = _Res2NetBlock(channels, scale, kernel_size, dilation)
        self.tdnn_out = _TDNNBlock(channels, channels, 1)
        self.se = _SEBlock(channels, se_channels)

    def forward(self, x, mask=None, train: bool = False):
        y = self.tdnn_in(x, mask, train)
        y = self.res2net(y, mask, train)
        y = self.tdnn_out(y, mask, train)
        return self.se(y, mask) + x


class EcapaTdnn(nn.Module):
    """Fbank features ``[B, T, mels]`` -> embedding ``[B, lin_neurons]``."""

    def __init__(self, cfg: EcapaConfig = EcapaConfig()):
        super().__init__()
        self.cfg = cfg
        ch, ks, ds = cfg.channels, cfg.kernel_sizes, cfg.dilations
        self.tdnn_0 = _TDNNBlock(cfg.in_channels, ch[0], ks[0], ds[0])
        for i in range(1, len(ch) - 1):
            self.add_module(f"se_res2net_{i - 1}", _SERes2NetBlock(
                ch[i - 1], ch[i], ks[i], ds[i], cfg.res2net_scale, cfg.se_channels))
        self.mfa = _TDNNBlock(sum(ch[1:-1]), ch[-1], ks[-1], ds[-1])
        self.asp = AttentiveStatPool(ch[-1], cfg.attention_channels, cfg.global_context)
        self.asp_bn = BatchNorm(2 * ch[-1])
        self.fc = nn.Linear(2 * ch[-1], cfg.lin_neurons)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        m = None if mask is None else mask.float()[:, None, :]
        h = self.tdnn_0(x.to(self.fc.weight.dtype).transpose(1, 2), m, train)
        outs = []
        for i in range(len(self.cfg.channels) - 2):
            h = getattr(self, f"se_res2net_{i}")(h, m, train)
            outs.append(h)
        h = self.mfa(torch.cat(outs, dim=1), m, train)
        pooled = self.asp(h.transpose(1, 2), mask, train=train)
        return self.fc(self.asp_bn(pooled, train))


class EcapaModel(nn.Module):
    """``EcapaTdnn`` under the AAM head (the recipe's) or a CE classifier.
    The model contract of ``SpeakerTask``: with AAM and ``labels`` the
    output also holds ``loss`` and ``preds``; ``generator`` is accepted and
    not read."""

    def __init__(self, cfg: EcapaConfig = EcapaConfig(), num_speakers: int = 100, use_aam: bool = True,
                 aam_margin: float = 0.2, aam_scale: float = 30.0):
        super().__init__()
        self.cfg, self.use_aam = cfg, use_aam
        self.backbone = EcapaTdnn(cfg)
        if use_aam:
            self.aam = AAMSoftmaxHead(cfg.lin_neurons, num_speakers, aam_margin, aam_scale)
        else:
            self.classifier = nn.Linear(cfg.lin_neurons, num_speakers)

    def forward(self, x, mask=None, train: bool = False, generator=None, labels=None) -> Dict[str, torch.Tensor]:
        emb = self.backbone(x, mask, train=train)
        out = {"embedding": emb, "logits": None}
        if not self.use_aam:
            out["logits"] = self.classifier(emb)
        elif labels is not None:
            out["loss"], out["preds"] = self.aam(emb, labels)
        return out

    def compute_embedding(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.backbone(x, mask, train=False)
