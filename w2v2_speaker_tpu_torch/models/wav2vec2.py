"""wav2vec2 backbone in PyTorch, eval only.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2.py``:

- ``Wav2Vec2Config`` (:53), ``BASE_CONFIG`` / ``LARGE_CONFIG`` (:175-184)
- ``feat_extract_output_lengths`` (:187)
- ``_MaskedChannelNorm`` (:211)
- ``ConvFeatureEncoder`` (:287), the default ``conv_impl="xla"`` path
- ``FeatureProjection`` (:420)
- ``PosConvEmbedding`` (:437)
- ``SelfAttention`` (:550)
- ``EncoderLayer`` (:602)
- ``Encoder`` (:713)
- ``Wav2Vec2Model`` (:777)

Public layouts are the JAX package's: waveforms ``[B, N]``, features
channels-last ``[B, T, F]``. Inside, the conv stack runs in PyTorch's
``[B, C, T]``. Parameter names follow the flax tree (``conv_0``,
``group_norm``, ``qkv_proj``, ...) so ``convert.params_from_jax`` is a
rename and a transpose. The backbone's parameters and its compute are in
``cfg.dtype``; norm statistics and the attention softmax run in float32.

A per-layer Python loop stands in for ``nn.scan``. Every attention call
goes through ``ops.flash_attention.flash_attention``: the hand-written CUDA
kernel on the card, its plain version on the CPU. There is no
``_kernel_profitable`` dispatch, and ``attention_impl`` picks nothing here.

Training (dropout, SpecAugment, layerdrop) and ``conv_impl="fused_pallas"``
raise ``NotImplementedError`` until later slices (ROADMAP Queue 1 item 5,
Queue 2 item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention

__all__ = [
    "Wav2Vec2Config",
    "Wav2Vec2Model",
    "BASE_CONFIG",
    "LARGE_CONFIG",
    "feat_extract_output_lengths",
    "init_parameters",
]

TRAINING_ROW = "ROADMAP.md Queue 1 item 5 (training step, slice 2)"


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Same fields, defaults and validation as the JAX package's config.

    Fields that only shape training or TPU code generation (dropout rates,
    layerdrop, SpecAugment, remat, scan unroll, posconv formulation,
    hash_dropout, attention_impl) are kept so configs carry over; they do
    not change this eval-only forward.
    """

    # conv feature encoder
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    # transformer
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    # regularisation (training only)
    feat_proj_dropout: float = 0.1
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    layerdrop: float = 0.05
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    # compute
    dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "nothing"  # "nothing" | "dots" | "dots_no_batch"
    posconv_decomposed: bool = True
    encoder_unroll: int = 1
    attention_impl: str = "flash"  # "flash" | "xla"
    conv_impl: str = "xla"  # "xla" | "fused_pallas"
    int8_matmuls: bool = False
    hash_dropout: bool = True

    def __post_init__(self):
        allowed = {
            "remat_policy": ("nothing", "dots", "dots_no_batch"),
            "attention_impl": ("flash", "xla"),
            "conv_impl": ("xla", "fused_pallas"),
            "feat_extract_norm": ("group", "layer"),
        }
        for field_name, options in allowed.items():
            value = getattr(self, field_name)
            if value not in options:
                raise ValueError(
                    f"Wav2Vec2Config.{field_name}={value!r} is not one of "
                    f"{options}"
                )


BASE_CONFIG = Wav2Vec2Config()
LARGE_CONFIG = Wav2Vec2Config(
    hidden_size=1024,
    num_layers=24,
    num_heads=16,
    intermediate_size=4096,
    feat_extract_norm="layer",
    conv_bias=True,
    do_stable_layer_norm=True,
)


def feat_extract_output_lengths(input_lengths, cfg: Wav2Vec2Config = BASE_CONFIG):
    """Frame count after the conv stack, on ints or integer tensors.

    Floor division, as in the JAX package: a length too short for the
    first conv comes out negative (0 samples -> -1 frames for BASE).
    """
    lengths = input_lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


def _suffix_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class _MaskedChannelNorm(nn.Module):
    """GroupNorm(num_groups=C) with statistics over valid frames only.

    Works on ``[B, C, T]``; the statistics are single-pass float32 moments
    over the frames ``t < lengths[b]`` (all frames for ``lengths=None``).
    ``nn.GroupNorm`` would take the padded frames into the statistics and
    break padding invariance.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(
        self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x32 = x.float()
        if lengths is None:
            n = float(x.shape[-1])
            s1 = x32.sum(-1, keepdim=True)
            s2 = (x32 * x32).sum(-1, keepdim=True)
        else:
            m = _suffix_mask(lengths, x.shape[-1]).float()[:, None, :]
            n = m.sum(-1, keepdim=True).clamp_min(1.0)
            s1 = (x32 * m).sum(-1, keepdim=True)
            s2 = (x32 * x32 * m).sum(-1, keepdim=True)
        mean = s1 / n
        var = (s2 / n - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float()[:, None] + self.bias.float()[:, None]
        return y.to(x.dtype)


class ConvFeatureEncoder(nn.Module):
    """Raw waveform ``[B, N]`` -> features ``[B, T, conv_dim[-1]]``.

    ``F.conv1d`` chain with exact GELU; BASE normalises the first layer's
    output with masked per-channel statistics, LARGE applies a LayerNorm
    over channels after every conv.
    """

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        if cfg.conv_impl == "fused_pallas":
            raise NotImplementedError(
                "conv_impl='fused_pallas' (the fused strided-conv kernel) is "
                "not ported yet: ROADMAP.md Queue 2 item 4"
            )
        self.cfg = cfg
        in_c = 1
        for i, (c, k, s) in enumerate(
            zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)
        ):
            self.add_module(
                f"conv_{i}", nn.Conv1d(in_c, c, k, stride=s, bias=cfg.conv_bias)
            )
            if cfg.feat_extract_norm == "layer":
                self.add_module(
                    f"layer_norm_{i}", nn.LayerNorm(c, eps=cfg.layer_norm_eps)
                )
            in_c = c
        if cfg.feat_extract_norm == "group":
            self.group_norm = _MaskedChannelNorm(cfg.conv_dim[0])

    def forward(
        self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        cfg = self.cfg
        x = wav[:, None, :].to(self.conv_0.weight.dtype)  # [B, 1, N]
        lengths = None if wav_mask is None else wav_mask.sum(-1)
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            x = getattr(self, f"conv_{i}")(x)
            if lengths is not None:
                lengths = (lengths - k) // s + 1
            if i == 0 and cfg.feat_extract_norm == "group":
                x = self.group_norm(x, lengths)
            elif cfg.feat_extract_norm == "layer":
                x = getattr(self, f"layer_norm_{i}")(x.transpose(1, 2))
                x = x.transpose(1, 2)
            x = F.gelu(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PosConvEmbedding(nn.Module):
    """Grouped conv positional embedding with weight-norm parameters in
    ``torch.nn.utils.weight_norm(conv, dim=2)`` layout: ``weight_v``
    ``[out, in/groups, k]`` and ``weight_g`` ``[1, 1, k]``, the norm taken
    per tap over ``weight_v.reshape(-1, k)``. For even ``k`` the trailing
    output frame is dropped (HF's SamePadLayer)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        h, k = cfg.hidden_size, cfg.num_conv_pos_embeddings
        self.groups = cfg.num_conv_pos_embedding_groups
        self.weight_v = nn.Parameter(torch.empty(h, h // self.groups, k))
        self.weight_g = nn.Parameter(torch.empty(1, 1, k))
        self.bias = nn.Parameter(torch.zeros(h))

    def weight(self) -> torch.Tensor:
        k = self.weight_v.shape[-1]
        norm = torch.linalg.vector_norm(self.weight_v.reshape(-1, k), dim=0)
        return self.weight_v * (self.weight_g / norm.clamp_min(1e-12))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, h]
        k = self.weight_v.shape[-1]
        out = F.conv1d(
            x.transpose(1, 2), self.weight(), self.bias,
            padding=k // 2, groups=self.groups,
        )
        if k % 2 == 0:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class SelfAttention(nn.Module):
    """Fused QKV projection -> flash attention over ``[B, T, H, D]`` views
    of the projection (no copy) -> output projection."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)

    def forward(
        self, x: torch.Tensor, lengths: Optional[torch.Tensor]
    ) -> torch.Tensor:
        b, t, h = x.shape
        q, k, v = (
            part.view(b, t, self.num_heads, h // self.num_heads)
            for part in self.qkv_proj(x).split(h, dim=-1)
        )
        out = flash_attention(q, k, v, lengths)
        return self.out_proj(out.reshape(b, t, h))


class EncoderLayer(nn.Module):
    """Post-norm (BASE) or pre-norm (LARGE, stable layer norm) block."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.pre = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def forward(
        self, x: torch.Tensor, lengths: Optional[torch.Tensor]
    ) -> torch.Tensor:
        if self.pre:
            x = x + self.attention(self.layer_norm(x), lengths)
            h = self.final_layer_norm(x)
        else:
            x = self.layer_norm(x + self.attention(x, lengths))
            h = x
        h = self.output_dense(F.gelu(self.intermediate_dense(h)))
        x = x + h
        return x if self.pre else self.final_layer_norm(x)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pre = cfg.do_stable_layer_norm
        self.pos_conv_embed = PosConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """``attention_mask`` ``[B, T]`` is suffix-contiguous (a True
        prefix); the attention kernel takes it as one int32 length per row,
        counted here once for all layers."""
        lengths = None
        if attention_mask is not None:
            # zero padded frames before the pos conv (HF does the same)
            x = x * attention_mask[:, :, None].to(x.dtype)
            lengths = attention_mask.sum(-1, dtype=torch.int32)
        x = x + self.pos_conv_embed(x)
        if not self.pre:
            x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x, lengths)
        if self.pre:
            x = self.layer_norm(x)
        return x


class Wav2Vec2Model(nn.Module):
    """Raw waveform ``[B, N]`` -> (float32 features ``[B, T, hidden]``,
    frame mask ``[B, T]`` or None)."""

    def __init__(self, cfg: Wav2Vec2Config = BASE_CONFIG):
        super().__init__()
        if cfg.int8_matmuls:
            raise NotImplementedError(
                "int8_matmuls is not ported yet: ROADMAP.md Queue 1 item 6"
            )
        self.cfg = cfg
        self.feature_encoder = ConvFeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        # SpecAugment's learned mask vector: unused in eval, kept so
        # checkpoints carry over
        self.masked_spec_embed = (
            nn.Parameter(torch.empty(cfg.hidden_size))
            if cfg.mask_time_prob > 0
            else None
        )
        self.encoder = Encoder(cfg)
        self.to(getattr(torch, cfg.dtype))

    def forward(
        self,
        wav: torch.Tensor,  # [B, N]
        wav_mask: Optional[torch.Tensor] = None,  # [B, N] validity
        train: bool = False,
    ):
        if train:
            raise NotImplementedError(
                f"train=True (dropout, SpecAugment, layerdrop) is not ported "
                f"yet: {TRAINING_ROW}"
            )
        features = self.feature_encoder(wav, wav_mask)
        frame_mask = None
        if wav_mask is not None:
            frame_lengths = feat_extract_output_lengths(wav_mask.sum(-1), self.cfg)
            frame_mask = _suffix_mask(frame_lengths, features.shape[1])
        x = self.feature_projection(features)
        x = self.encoder(x, attention_mask=frame_mask)
        return x.float(), frame_mask


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator``, with the JAX package's
    initialisers: dense and conv kernels lecun-normal (truncated at two
    standard deviations), biases 0, norm scales 1, the pos-conv ``weight_v``
    uniform in +-1/sqrt(fan_in) with ``weight_g`` its per-tap norm, and
    ``masked_spec_embed`` uniform in [0, 1). Values are drawn in float32
    and rounded to each parameter's dtype. The generator must be on the
    parameters' device."""

    def draw(p: torch.Tensor, fill) -> torch.Tensor:
        x = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        fill(x)
        p.copy_(x)
        return x

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
            draw(m.weight, lambda x: nn.init.trunc_normal_(
                x, std=std, a=-2 * std, b=2 * std, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, _MaskedChannelNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, PosConvEmbedding):
            bound = m.weight_v[0].numel() ** -0.5
            v = draw(m.weight_v, lambda x: nn.init.uniform_(
                x, -bound, bound, generator=generator))
            k = v.shape[-1]
            m.weight_g.copy_(torch.linalg.vector_norm(v.reshape(-1, k), dim=0).reshape(1, 1, k))
            m.bias.zero_()
        elif isinstance(m, Wav2Vec2Model) and m.masked_spec_embed is not None:
            draw(m.masked_spec_embed, lambda x: nn.init.uniform_(
                x, 0.0, 1.0, generator=generator))
