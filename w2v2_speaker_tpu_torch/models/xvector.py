"""X-vector speaker embedding network (Snyder et al. 2018).

Counterpart of ``w2v2_speaker_tpu/models/xvector.py``: ``XVectorConfig``
(:31), ``TDNNBlock`` (:42: dilated conv with SAME padding, ReLU, then
``BatchNorm``), ``XVector`` (:71: the padding frames zeroed before every
block, masked mean + std pooling, the ``embedding`` layer),
``XVectorClassifier`` (:101: per block leaky ReLU 0.01, ``BatchNorm`` and a
dense layer, then ``out``) and ``XVectorModel`` (:126). Submodules carry
the flax names (``backbone.tdnn_0.conv``, ``classifier.bn_0``), so
converted parameters load strictly.

The TDNN stack runs channels-first (``[B, C, T]``, ``nn.Conv1d``, the
``BatchNorm`` over axis 1); the JAX package is channels-last. Training
``BatchNorm`` takes its statistics over every frame, padding included, as
the reference's does: the masking rule decides what those frames hold, so
it is kept as is. The network computes in its parameters' type (float32,
as the JAX package builds it; float64 where a caller converts it, as
``chip_smoke.py``'s reference step does); the convolutions and products
are library calls, as they are XLA (not Pallas) in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .pooling import BatchNorm, MeanStdPool

__all__ = ["TDNNBlock", "XVector", "XVectorClassifier", "XVectorConfig", "XVectorModel"]


@dataclass(frozen=True)
class XVectorConfig:
    in_channels: int = 40
    tdnn_channels: Tuple[int, ...] = (512, 512, 512, 512, 1500)
    tdnn_kernel_sizes: Tuple[int, ...] = (5, 3, 3, 1, 1)
    tdnn_dilations: Tuple[int, ...] = (1, 2, 3, 1, 1)
    lin_neurons: int = 512  # embedding size
    lin_blocks: int = 1  # hidden blocks in the classifier


class TDNNBlock(nn.Module):
    """Dilated 1-D conv with SAME padding, ReLU, ``BatchNorm``; ``[B, C, T]``."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, channels, kernel_size, dilation=dilation, padding="same")
        self.bn = BatchNorm(channels, axis=1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(F.relu(self.conv(x)), train)


class XVector(nn.Module):
    """TDNN stack + masked stats pooling + embedding projection:
    ``[B, T, in_channels]`` features -> ``[B, lin_neurons]``."""

    def __init__(self, cfg: XVectorConfig = XVectorConfig()):
        super().__init__()
        self.cfg = cfg
        c_in = cfg.in_channels
        for i, (c, k, d) in enumerate(zip(cfg.tdnn_channels, cfg.tdnn_kernel_sizes, cfg.tdnn_dilations)):
            self.add_module(f"tdnn_{i}", TDNNBlock(c_in, c, k, d))
            c_in = c
        self.stats_pool = MeanStdPool()
        self.embedding = nn.Linear(2 * c_in, cfg.lin_neurons)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        h = x.to(self.embedding.weight.dtype).transpose(1, 2)
        m = None if mask is None else mask.float()[:, None, :]
        for i in range(len(self.cfg.tdnn_channels)):
            if m is not None:
                h = h * m  # zero the padding frames, so SAME-padded convs do not read them
            h = getattr(self, f"tdnn_{i}")(h, train)
        return self.embedding(self.stats_pool(h.transpose(1, 2), mask))


class XVectorClassifier(nn.Module):
    """Per block leaky ReLU + ``BatchNorm`` + dense, then ``out``: logits."""

    def __init__(self, num_speakers: int, lin_neurons: int = 512, lin_blocks: int = 1):
        super().__init__()
        self.lin_blocks = lin_blocks
        for i in range(lin_blocks):
            self.add_module(f"bn_{i}", BatchNorm(lin_neurons))
            self.add_module(f"lin_{i}", nn.Linear(lin_neurons, lin_neurons))
        self.out = nn.Linear(lin_neurons, num_speakers)

    def forward(self, emb: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = emb
        for i in range(self.lin_blocks):
            x = getattr(self, f"bn_{i}")(F.leaky_relu(x, 0.01), train)
            x = getattr(self, f"lin_{i}")(x)
        return self.out(x)


class XVectorModel(nn.Module):
    """Embedding network + classifier. The model contract of
    ``SpeakerTask``: ``generator`` and ``labels`` are accepted and not
    read."""

    def __init__(self, cfg: XVectorConfig = XVectorConfig(), num_speakers: int = 100):
        super().__init__()
        self.cfg = cfg
        self.backbone = XVector(cfg)
        self.classifier = XVectorClassifier(num_speakers, cfg.lin_neurons, cfg.lin_blocks)

    def forward(self, x, mask=None, train: bool = False, generator=None, labels=None) -> Dict[str, torch.Tensor]:
        emb = self.backbone(x, mask, train=train)
        return {"embedding": emb, "logits": self.classifier(emb, train=train)}

    def compute_embedding(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.backbone(x, mask, train=False)
