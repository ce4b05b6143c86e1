"""Masked pooling ``[B, T, F] -> [B, F']``: the pooling zoo.

Counterpart of ``w2v2_speaker_tpu/models/pooling.py``: ``masked_mean_std``
(:60), ``MeanPool`` (:75), ``MeanStdPool`` (:82), ``MaxPool`` (:90),
``QuantilePool`` (:98), ``AttentiveStatPool`` (:131), ``IndexPool``
(:188), ``NoPool`` (:215), ``get_pooling`` (:236) and
``pooled_embedding_size`` (:244), under the same names as the
``stat_pooling_type`` values. Every op takes the frame mask (None: every
frame valid) and is exactly invariant to padding; ``middle`` takes the
true middle of the valid frames.

Every op is called as ``pool(x, mask, train=False, generator=None)``.
``AttentiveStatPool`` normalises its attention hidden layer with
``BatchNorm``, flax's ``nn.BatchNorm(momentum=0.9)`` written out;
``IndexPool("random")`` draws its frame from ``generator`` in training
and takes ``lengths // 2`` in eval. Plain PyTorch on the card too: the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import global_sum
from .masking import draw_row_uniform

__all__ = [
    "AttentiveStatPool", "BatchNorm", "IndexPool", "MaxPool", "MeanPool", "MeanStdPool", "NoPool",
    "QuantilePool", "get_pooling", "masked_mean_std", "pooled_embedding_size",
]

_EPS = 1e-12
# The reference's AttentiveStatPool defaults (:142-143, :170): the values
# its wav2vec2 networks build.
_ATTENTION_CHANNELS = 128
_BN_MOMENTUM, _BN_EPS = 0.9, 1e-5
_INDEX = ("first", "first+cls", "middle", "last", "random")


def _full_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    return mask.float()


def masked_mean_std(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """(mean, std) over the valid frames of ``x`` [B, T, F]; the std divides
    by max(n - 1, 1) (ddof 1, the only value the reference's callers use),
    with 1e-10 inside the sqrt (a constant channel keeps a finite
    gradient)."""
    m = _full_mask(x, mask)[:, :, None]
    n = m.sum(dim=1).clamp_min(1.0)
    mean = (x * m).sum(dim=1) / n
    var = ((x - mean[:, None, :]) ** 2 * m).sum(dim=1) / (n - 1).clamp_min(1.0)
    return mean, (var.clamp_min(0.0) + 1e-10).sqrt()


class MeanPool(nn.Module):
    """Mean over valid frames; an all-invalid row pools to 0."""

    def forward(self, x, mask=None, train=False, generator=None):
        if mask is None:
            return x.mean(dim=1)
        m = mask.to(x.dtype)[:, :, None]
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class MeanStdPool(nn.Module):
    """(std, mean) concatenated, in the reference's order (torch.std_mean's
    tuple), std with ddof 1."""

    def forward(self, x, mask=None, train=False, generator=None):
        mean, std = masked_mean_std(x, mask)
        return torch.cat([std, mean], dim=-1)


class MaxPool(nn.Module):
    def forward(self, x, mask=None, train=False, generator=None):
        m = _full_mask(x, mask)[:, :, None]
        return torch.where(m > 0, x, torch.finfo(x.dtype).min).amax(dim=1)


class QuantilePool(nn.Module):
    """Quantiles (0, .25, .5, .75, 1) of the valid frames, linear
    interpolation at q (len - 1) as ``torch.quantile``; output [B, 5 F],
    quantile-major. Invalid frames sort last, filled with the type's max."""

    quantiles = (0.0, 0.25, 0.5, 0.75, 1.0)

    def forward(self, x, mask=None, train=False, generator=None):
        b, t, f = x.shape
        m = _full_mask(x, mask)
        lengths = m.sum(dim=1)
        x_sorted = torch.where(m[:, :, None] > 0, x, torch.finfo(x.dtype).max).sort(dim=1).values
        q = torch.tensor(self.quantiles, dtype=torch.float32, device=x.device)
        pos = q[None, :] * (lengths[:, None] - 1.0)  # [B, Q]
        lo = pos.floor().clamp(0, t - 1).long()
        hi = pos.ceil().clamp(0, t - 1).long()
        w = (pos - lo.float())[:, :, None]
        v_lo = x_sorted.gather(1, lo[:, :, None].expand(b, len(self.quantiles), f))
        v_hi = x_sorted.gather(1, hi[:, :, None].expand(b, len(self.quantiles), f))
        return (v_lo * (1.0 - w) + v_hi * w).reshape(b, len(self.quantiles) * f)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the feature
    axis ``axis`` (the last by default; 1 for a channels-first
    ``[B, C, T]`` input), not ``nn.BatchNorm1d``, which differs in three
    ways: in training the statistics run over every position of every
    other axis (padded frames included: the reference passes no mask); the
    running variance takes the biased variance E[x^2] - E[x]^2 (clipped at
    0); and a running value moves as 0.9 old + 0.1 new. In a data-parallel
    microbatch the statistics run over the global microbatch (sums and
    count all-reduced, differentiably), so every rank keeps the same
    running values, as under the JAX package's GSPMD. Eval normalises
    with the running buffers, which ride the ``state_dict`` (checkpoints,
    resume)."""

    def __init__(self, features: int, axis: int = -1):
        super().__init__()
        self.axis = axis
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """flax's initial values: scale 1, bias 0, mean 0, variance 1."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        axis = self.axis % x.ndim
        if train:
            axes = tuple(d for d in range(x.ndim) if d != axis)
            x32 = x.to(torch.promote_types(x.dtype, torch.float32))
            count = torch.full_like(x32.sum(dim=axes), float(x32.numel() // x32.shape[axis]))
            sums = global_sum(torch.stack([x32.sum(dim=axes), (x32 * x32).sum(dim=axes), count]))
            mean = sums[0] / sums[2]
            var = (sums[1] / sums[2] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(_BN_MOMENTUM).add_((1 - _BN_MOMENTUM) * mean)
                self.running_var.mul_(_BN_MOMENTUM).add_((1 - _BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = [-1 if d == axis else 1 for d in range(x.ndim)]
        scale = (torch.rsqrt(var + _BN_EPS) * self.weight).view(shape)
        return (x - mean.view(shape)) * scale + self.bias.view(shape)


class AttentiveStatPool(nn.Module):
    """Attentive statistics pooling (speechbrain's structure): the input is
    (x, masked mean, masked std) per frame with ``global_context``, else x
    alone; a dense layer to ``attention_channels``, ReLU, ``BatchNorm``,
    tanh, a dense layer back to F, softmax over the valid frames, then the
    weighted mean and std -> [B, 2 F]. The wav2vec2 networks take the
    defaults; ECAPA-TDNN passes its config's values."""

    def __init__(self, features: int, attention_channels: int = _ATTENTION_CHANNELS,
                 global_context: bool = True):
        super().__init__()
        self.global_context = global_context
        self.attn_tdnn = nn.Linear((3 if global_context else 1) * features, attention_channels)
        self.attn_bn = BatchNorm(attention_channels)
        self.attn_proj = nn.Linear(attention_channels, features)

    def forward(self, x, mask=None, train=False, generator=None):
        m3 = _full_mask(x, mask)[:, :, None]
        x_in = x
        if self.global_context:
            n = m3.sum(dim=1, keepdim=True).clamp_min(1.0)
            mean = (x * m3).sum(dim=1, keepdim=True) / n
            std = (((x - mean) ** 2 * m3).sum(dim=1, keepdim=True) / n).clamp_min(_EPS).sqrt()
            x_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        h = torch.tanh(self.attn_bn(F.relu(self.attn_tdnn(x_in)), train))
        e = self.attn_proj(h)
        e = torch.where(m3 > 0, e, torch.finfo(e.dtype).min)
        w = torch.softmax(e, dim=1) * m3
        mean = (w * x).sum(dim=1)
        std = (w * (x - mean[:, None, :]) ** 2).sum(dim=1).clamp_min(_EPS).sqrt()
        return torch.cat([mean, std], dim=-1)


class IndexPool(nn.Module):
    """One frame per row: ``first`` and ``first+cls`` frame 0, ``middle``
    lengths // 2, ``last`` lengths - 1, ``random`` floor(u lengths) with u
    uniform from ``generator`` in training (lengths // 2 in eval). A
    negative index counts from the end, as the JAX gather takes it."""

    def __init__(self, method: str):
        super().__init__()
        if method not in _INDEX:
            raise ValueError(f"unknown index pooling method {method}")
        self.method = method

    def forward(self, x, mask=None, train=False, generator=None):
        b, t, f = x.shape
        if self.method in ("first", "first+cls"):
            return x[:, 0, :]
        lengths = _full_mask(x, mask).sum(dim=1).long()
        if self.method == "middle" or (self.method == "random" and not train):
            idx = lengths // 2
        elif self.method == "last":
            idx = lengths - 1
        else:
            if generator is None:
                raise ValueError("random pooling in training needs the train step's torch.Generator")
            u = draw_row_uniform(generator, (b,), x.device)
            idx = torch.minimum((u * lengths.float()).floor().long().clamp_min(0), lengths - 1)
        idx = torch.remainder(idx, t)
        return x.gather(1, idx[:, None, None].expand(b, 1, f))[:, 0, :]


class NoPool(nn.Module):
    def forward(self, x, mask=None, train=False, generator=None):
        return x


def get_pooling(name: str, features: int) -> nn.Module:
    """The pooling op ``name`` over ``features`` input features."""
    if name == "attentive":
        return AttentiveStatPool(features)
    if name in _INDEX:
        return IndexPool(name)
    plain = {"mean": MeanPool, "mean+std": MeanStdPool, "quantile": QuantilePool, "max": MaxPool,
             "none": NoPool}
    if name not in plain:
        raise ValueError(f"unknown pooling '{name}', available: {sorted([*plain, 'attentive', *_INDEX])}")
    return plain[name]()


def pooled_embedding_size(name: str, feature_size: int) -> int:
    """Output feature count of a pooling op given its input feature count."""
    if name in ("mean", "max", "none", *_INDEX):
        return feature_size
    if name in ("mean+std", "attentive"):
        return 2 * feature_size
    if name == "quantile":
        return 5 * feature_size
    raise ValueError(f"unknown pooling '{name}'")
