"""wav2vec2 backbone in PyTorch, eval and training.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2.py``:

- ``Wav2Vec2Config`` (:53), ``BASE_CONFIG`` / ``LARGE_CONFIG`` (:175-184)
- ``feat_extract_output_lengths`` (:187)
- ``_MaskedChannelNorm`` (:211)
- ``ConvFeatureEncoder`` (:287), both routes: ``conv_impl="xla"`` and the
  fused strided-conv kernel of ``conv_impl="fused_pallas"`` (:318-346)
- ``HashDropout`` (:373)
- ``FeatureProjection`` (:420)
- ``PosConvEmbedding`` (:437)
- ``SelfAttention`` (:550)
- ``EncoderLayer`` (:602)
- ``Encoder`` (:713), with ``output_hidden_states`` (:722-773)
- ``Wav2Vec2Model`` (:777), with ``output_hidden_states`` (:794, :863-875)
- ``Wav2Vec2LiteEncoder`` (:879): the conv feature encoder alone

Public layouts are the JAX package's: waveforms ``[B, N]``, features
channels-last ``[B, T, F]``. Inside, the conv stack runs in PyTorch's
``[B, C, T]``. Parameter names follow the flax tree (``conv_0``,
``group_norm``, ``qkv_proj``, ...) so ``convert.params_from_jax`` is a
rename and a transpose. ``cfg.dtype`` is the compute type. Parameters are
created in float32, as flax's ``param_dtype`` keeps them: training keeps
them so and runs the forward under ``torch.autocast`` in bfloat16 when
``cfg.dtype`` is bfloat16 (the role of ``trainer.precision``); serving casts
the weights themselves to bfloat16 (``entry.build_model``) and then needs no
autocast. Norm statistics and the attention softmax run in float32; under
autocast every LayerNorm hands its output on in the compute type
(``LayerNorm``), as flax's ``LayerNorm(dtype=...)`` does.

A per-layer Python loop stands in for ``nn.scan`` (``encoder_unroll``
unrolls nothing here). Every attention call goes through
``ops.flash_attention.flash_attention``: the hand-written CUDA kernels on
the card (forward, and dq and dk/dv under autograd), their plain versions
on the CPU. There is no ``_kernel_profitable`` dispatch, and
``attention_impl`` picks nothing here; ``posconv_decomposed`` (a TPU
formulation of the pos conv) changes nothing either.

``int8_matmuls`` makes the five dense sites of the JAX ``_dense`` (:201)
``ops.quant.QuantLinear``: the feature projection, ``qkv_proj``,
``out_proj``, ``intermediate_dense`` and ``output_dense``. They keep
``nn.Linear``'s parameters, and serve only: a forward that needs a
gradient raises.

``remat`` (<- ``nn.remat`` per layer, :699-706) runs each kept layer of a
training forward under ``torch.utils.checkpoint`` (``use_reentrant=False``),
which recomputes the whole layer in the backward. ``remat_policy`` is
read and validated but changes nothing beyond ``remat``: every policy
recomputes the whole layer. The JAX policies ``dots`` / ``dots_no_batch``
choose which XLA dot outputs to keep; here a selective checkpoint that
kept the dense products was slower than full recompute on an H100 at
the same peak memory (PERF.md), and the attention kernels, inside an
``autograd.Function``, would be recomputed under any policy. A
checkpoint restores the default CUDA generator, not the step's
``torch.Generator``: so every random draw of a layer (its dropout seeds,
or its Bernoulli masks) is drawn before the layer runs (``draw_noise``)
and handed to it, with remat and without, in the same order as the layer
used to draw them. Remat changes no number.

Training (``train=True``) takes the train step's ``torch.Generator``; every
random draw of the forward comes from it, in a fixed order: one int32 seed
per dropout site (the counter-hash masks of ``HashDropout`` and of the
attention kernel), the SpecAugment uniforms, one coin per layer for
layerdrop. A dropped layer is skipped outright: its output is its input, as
the JAX ``where`` (:620-625) gives, and its parameters get zero gradients
from the train step. ``conv_impl="fused_pallas"`` sends the eligible conv
layers (1-6 of BASE and LARGE) through ``ops.conv_encoder``'s fused
conv + bias + LayerNorm + GELU: the hand-written kernel on the card, its
plain version on the CPU.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv_encoder
from ..ops.flash_attention import attention_dropout_keep, draw_seed, flash_attention
from ..ops.quant import QuantLinear
from .heads import AAMSoftmaxHead
from ..parallel.mesh import active_rows
from .masking import draw_row_uniform, sample_span_mask
from .temporal_gate import TemporalGate

__all__ = [
    "HashDropout",
    "LayerNorm",
    "Wav2Vec2Config",
    "Wav2Vec2LiteEncoder",
    "Wav2Vec2Model",
    "BASE_CONFIG",
    "LARGE_CONFIG",
    "feat_extract_output_lengths",
    "init_parameters",
]

@dataclass(frozen=True)
class Wav2Vec2Config:
    """Same fields, defaults and validation as the JAX package's config.

    ``remat`` checkpoints the encoder layers (every ``remat_policy``
    recomputes the whole layer) and
    ``int8_matmuls`` serves the dense sites in int8 (see the module's
    docstring); the fields that shape only TPU code generation
    (``encoder_unroll``, ``posconv_decomposed``, ``attention_impl``) are
    kept so configs carry over, and change nothing here.
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


def _dense(cfg: Wav2Vec2Config, in_features: int, out_features: int) -> nn.Linear:
    """``nn.Linear``, or its int8 twin when ``cfg.int8_matmuls`` (the same
    parameters either way), as the JAX ``_dense`` (:201)."""
    return (QuantLinear if cfg.int8_matmuls else nn.Linear)(in_features, out_features)


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


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose output, under autocast, is rounded to the
    autocast type, as the JAX package's ``LayerNorm(dtype=cfg.dtype)``
    rounds it (:364-368, 653-655, 681-685, 738-740, 766-768). Statistics
    and affine run in float32 on every device: CUDA autocast runs
    ``layer_norm`` in float32 and returns float32, which would hand float32
    on to the residual stream and the GELUs; CPU autocast would keep the
    input's type. Outside autocast (float32, or serving on bfloat16
    weights) it is ``nn.LayerNorm``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device.type
        if not torch.is_autocast_enabled(dev):
            return super().forward(x)
        with torch.autocast(dev, enabled=False):
            y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                             self.bias.float(), self.eps)
        return y.to(torch.get_autocast_dtype(dev))


class ConvFeatureEncoder(nn.Module):
    """Raw waveform ``[B, N]`` -> features ``[B, T, conv_dim[-1]]``.

    ``F.conv1d`` chain with exact GELU in ``[B, C, T]``; BASE normalises the
    first layer's output with masked per-channel statistics, LARGE applies
    a LayerNorm over channels after every conv. With
    ``conv_impl="fused_pallas"`` each eligible layer (k 2 or 3, stride 2,
    C -> C, C % 128 == 0) is one ``StridedConvFusedFunction`` call in
    channels-last ``[B, T, C]``, in the compute type ``cfg.dtype``, with the
    same parameters; the others stay on the chain. The lengths update runs
    on both routes.
    """

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
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
                    f"layer_norm_{i}", LayerNorm(c, eps=cfg.layer_norm_eps)
                )
            in_c = c
        if cfg.feat_extract_norm == "group":
            self.group_norm = _MaskedChannelNorm(cfg.conv_dim[0])

    def forward(
        self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        cfg = self.cfg
        fused = cfg.conv_impl == "fused_pallas"
        x = wav[:, None, :].to(self.conv_0.weight.dtype)  # [B, 1, N]
        channels_last = False
        lengths = None if wav_mask is None else wav_mask.sum(-1)
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            conv = getattr(self, f"conv_{i}")
            ln = getattr(self, f"layer_norm_{i}", None)
            if lengths is not None:
                lengths = (lengths - k) // s + 1
            if fused and conv_encoder.eligible(k, s, conv.in_channels, c):
                if not channels_last:
                    x, channels_last = x.transpose(1, 2), True
                x = conv_encoder.StridedConvFusedFunction.apply(
                    x.to(getattr(torch, cfg.dtype)), conv.weight.permute(2, 1, 0), conv.bias,
                    None if ln is None else ln.weight, None if ln is None else ln.bias,
                    cfg.layer_norm_eps, True,
                )
            else:
                if channels_last:
                    x, channels_last = x.transpose(1, 2), False
                x = conv(x)
                if i == 0 and cfg.feat_extract_norm == "group":
                    x = self.group_norm(x, lengths)
                elif ln is not None:
                    x = ln(x.transpose(1, 2)).transpose(1, 2)
                x = F.gelu(x)
        return x if channels_last else x.transpose(1, 2)


def hash_dropout(x: torch.Tensor, rate: float, seed: int, row0: int = 0,
                 cols: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``x`` [B, T, C] with the counter-hash keep mask
    ``attention_dropout_keep(seed, B, 1, T, C)`` (bh = batch, q = time,
    k = channel): kept entries divided by 1 - rate, the rest 0. ``row0``:
    the global row of ``x``'s first row; ``cols`` = (first column, width)
    of ``x``'s channels in a wider global input (width 0: ``x``'s own).
    The mask is the global mask's block there."""
    b, t, c = x.shape
    col0, width = cols
    keep = attention_dropout_keep(seed, b, 1, t, width or c, rate, x.device, (row0, 0, 1))[:, 0, :, col0:col0 + c]
    return torch.where(keep, _div_keep(x, rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _div_keep(x: torch.Tensor, rate: float) -> torch.Tensor:
    # x / (1 - rate) with the divisor in x's type, as JAX's weakly typed
    # Python float becomes (bf16(0.9) in a bf16 forward)
    return x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)


Noise = Union[None, int, torch.Tensor]  # a dropout site's draw: none, a hash seed, a keep mask


class HashDropout(nn.Module):
    """Dropout at one site of the backbone (<- ``HashDropout`` :373).

    ``forward(x, generator)``: ``generator`` None (eval) or a rate of 0
    returns ``x``. Otherwise the mask is the counter hash of one int32 seed
    drawn from ``generator`` (``use_hash``, the default), or, with
    ``hash_dropout=False``, ``torch.bernoulli`` drawn on ``generator`` and
    moved to ``x``'s device. ``draw(shape, generator)`` makes that draw
    alone and ``apply(x, noise)`` uses it, for a caller that draws ahead
    (``EncoderLayer.draw_noise``). In a data-parallel microbatch
    (``parallel.mesh.active_rows``) the hash runs at the rank's global rows
    and the Bernoulli mask is drawn at the global microbatch's shape and
    cut to the rank's rows (and, under tensor parallelism, the activation
    dropout of a rank's intermediate shard takes its columns, ``cols``), so
    every rank applies its block of the global masks. Plain PyTorch on the card too: the JAX
    package runs it as XLA ops, not as a Pallas kernel (a fused Triton
    version is later work, ROADMAP Queue 1 item 4).
    """

    def __init__(self, rate: float, use_hash: bool = True):
        super().__init__()
        self.rate, self.use_hash = rate, use_hash
        self.cols = (0, 0)  # (first column, width) of a tensor-parallel shard's input; width 0: all of it

    def draw(self, shape, generator: Optional[torch.Generator]) -> Noise:
        if generator is None or self.rate <= 0.0:
            return None
        if self.use_hash:
            return draw_seed(generator)
        s, shape = active_rows(), list(shape)
        if s is not None:
            shape[0] = s.total
        if self.cols[1]:
            shape[-1] = self.cols[1]
        return torch.bernoulli(torch.full(tuple(shape), 1.0 - self.rate), generator=generator)

    def apply(self, x: torch.Tensor, noise: Noise) -> torch.Tensor:
        if noise is None:
            return x
        s = active_rows()
        if isinstance(noise, int):
            return hash_dropout(x, self.rate, noise, 0 if s is None else s.offset, self.cols)
        keep = noise if s is None else s.take(noise)
        if self.cols[1]:
            keep = keep[..., self.cols[0]:self.cols[0] + x.shape[-1]]
        keep = keep.to(device=x.device, dtype=torch.bool)
        return torch.where(keep, _div_keep(x, self.rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return self.apply(x, self.draw(x.shape, generator))


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = _dense(cfg, cfg.conv_dim[-1], cfg.hidden_size)
        self.dropout = HashDropout(cfg.feat_proj_dropout, cfg.hash_dropout)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return self.dropout(self.projection(self.layer_norm(x)), generator)


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
        x, w, b = x.transpose(1, 2), self.weight(), self.bias
        on_cpu = x.device.type == "cpu"
        dtype = torch.get_autocast_dtype("cpu") if on_cpu and torch.is_autocast_enabled("cpu") else x.dtype
        if on_cpu and dtype != torch.float32:
            # oneDNN's bf16 grouped conv is wrong at 8 channels per group
            # (max error ~100 % of the output on torch 2.13's CPU build);
            # sum in float32 the operands rounded to the compute type, as
            # cuDNN does on the card, and round the output once
            with torch.autocast("cpu", enabled=False):
                out = F.conv1d(
                    *(t.to(dtype).float() for t in (x, w, b)),
                    padding=k // 2, groups=self.groups,
                ).to(dtype)
        else:
            out = F.conv1d(x, w, b, padding=k // 2, groups=self.groups)
        if k % 2 == 0:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class SelfAttention(nn.Module):
    """Fused QKV projection -> flash attention over ``[B, T, H, D]`` views
    of the projection (no copy) -> output projection. In training the
    attention-prob dropout runs inside the kernels, from one seed
    (``seed``, drawn by ``EncoderLayer.draw_noise``) at the global (row,
    head) coordinates of the rank's rows (``parallel.mesh.active_rows``)
    and heads (``head0`` of ``total_heads``, set by ``parallel.tp``; 0 of 0
    is all of them); without a seed there is no dropout."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads  # this rank's heads
        self.head_dim = h // cfg.num_heads
        self.head0, self.total_heads = 0, 0
        self.dropout = cfg.attention_dropout
        self.qkv_proj = _dense(cfg, h, 3 * h)
        self.out_proj = _dense(cfg, h, h)

    def forward(
        self,
        x: torch.Tensor,
        lengths: Optional[torch.Tensor],
        seed: Optional[int] = None,
    ) -> torch.Tensor:
        b, t, _ = x.shape
        width = self.num_heads * self.head_dim
        q, k, v = (
            part.view(b, t, self.num_heads, self.head_dim)
            for part in self.qkv_proj(x).split(width, dim=-1)
        )
        rate = self.dropout if seed is not None else 0.0
        s = active_rows()
        coords = (0 if s is None else s.offset, self.head0, self.total_heads)
        out = flash_attention(q, k, v, lengths, rate, seed, coords)
        return self.out_proj(out.reshape(b, t, width))


class EncoderLayer(nn.Module):
    """Post-norm (BASE) or pre-norm (LARGE, stable layer norm) block."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.pre = cfg.do_stable_layer_norm
        self.attention = SelfAttention(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=eps)
        self.intermediate_dense = _dense(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = _dense(cfg, cfg.intermediate_size, cfg.hidden_size)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=eps)
        self.attn_dropout = HashDropout(cfg.hidden_dropout, cfg.hash_dropout)  # :647
        self.act_dropout = HashDropout(cfg.activation_dropout, cfg.hash_dropout)  # :670
        self.out_dropout = HashDropout(cfg.hidden_dropout, cfg.hash_dropout)  # :675

    def draw_noise(self, shape, generator: Optional[torch.Generator]) -> Tuple[Noise, ...]:
        """Every random draw of the layer for an input of ``shape`` [B, T,
        H], in the order the JAX layer makes them: the attention dropout's
        seed, then the attention output's, the activation's and the
        output's dropout draws. All None without a generator (eval)."""
        b, t, _ = shape
        seed = draw_seed(generator) if generator is not None and self.attention.dropout > 0.0 else None
        return (seed, self.attn_dropout.draw(shape, generator),
                self.act_dropout.draw((b, t, self.intermediate_dense.out_features), generator),
                self.out_dropout.draw(shape, generator))

    def forward(
        self,
        x: torch.Tensor,
        lengths: Optional[torch.Tensor],
        noise: Tuple[Noise, ...] = (None, None, None, None),
    ) -> torch.Tensor:
        seed, attn_noise, act_noise, out_noise = noise
        attn = self.attention(self.layer_norm(x) if self.pre else x, lengths, seed)
        x = x + self.attn_dropout.apply(attn, attn_noise)
        if not self.pre:
            x = self.layer_norm(x)
        h = F.gelu(self.intermediate_dense(self.final_layer_norm(x) if self.pre else x))
        h = self.output_dense(self.act_dropout.apply(h, act_noise))
        x = x + self.out_dropout.apply(h, out_noise)
        return x if self.pre else self.final_layer_norm(x)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pre = cfg.do_stable_layer_norm
        self.layerdrop = cfg.layerdrop
        self.pos_conv_embed = PosConvEmbedding(cfg)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = HashDropout(cfg.hidden_dropout, cfg.hash_dropout)  # :741
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.layers_run = cfg.num_layers  # layers the last forward ran
        self.remat = cfg.remat

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        output_hidden_states: bool = False,
    ):
        """``attention_mask`` ``[B, T]`` is suffix-contiguous (a True
        prefix); the attention kernels take it as one int32 length per row,
        counted here once for all layers. With a ``generator`` (training)
        each layer is kept where a uniform drawn from it is below
        1 - layerdrop (:620-625), and skipped otherwise (its state is its
        input); a kept layer's draws come next (``draw_noise``), and with
        ``remat`` in a forward that records gradients the layer runs
        under ``checkpoint``. With ``output_hidden_states`` returns (output, states):
        the layers' input, then each layer's output, the last one replaced
        by the final LayerNorm's output in the pre-norm layout."""
        lengths = None
        if attention_mask is not None:
            # zero padded frames before the pos conv (HF does the same)
            x = x * attention_mask[:, :, None].to(x.dtype)
            lengths = attention_mask.sum(-1, dtype=torch.int32)
        x = x + self.pos_conv_embed(x)
        if not self.pre:
            x = self.layer_norm(x)
        x = self.dropout(x, generator)
        states = [x] if output_hidden_states else None
        self.layers_run = 0
        for layer in self.layers:
            if generator is None or self.layerdrop <= 0.0 or (
                float(torch.rand((), generator=generator)) < 1.0 - self.layerdrop
            ):
                noise = layer.draw_noise(x.shape, generator)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(layer, x, lengths, noise, use_reentrant=False)
                else:
                    x = layer(x, lengths, noise)
                self.layers_run += 1
            if states is not None:
                states.append(x)
        if self.pre:
            x = self.layer_norm(x)
            if states is not None:
                states[-1] = x
        return x if states is None else (x, states)


def _compute_context(device: torch.device, compute: torch.dtype, params: torch.dtype):
    """Autocast to ``compute`` when the parameters are float32 and the
    compute type is narrower; nothing when they agree."""
    if compute == params:
        return contextlib.nullcontext()
    if params == torch.float32 and compute in (torch.bfloat16, torch.float16):
        return torch.autocast(device.type, dtype=compute)
    raise ValueError(f"compute dtype {compute} with {params} parameters is not supported")


class Wav2Vec2Model(nn.Module):
    """Raw waveform ``[B, N]`` -> (float32 features ``[B, T, hidden]``,
    frame mask ``[B, T]`` or None). With ``insert_cls_token`` a row of
    ones (the reference's ``cls_token_constant``, which no network of it
    sets) goes in front of the projected frames, after
    SpecAugment and before the encoder (:852-861): the features are
    ``[B, 1 + T, hidden]`` and the frame mask, where there is one, gains a
    leading True."""

    def __init__(self, cfg: Wav2Vec2Config = BASE_CONFIG, insert_cls_token: bool = False):
        super().__init__()
        self.cfg = cfg
        self.insert_cls_token = insert_cls_token
        self.feature_encoder = ConvFeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        # SpecAugment's learned mask vector (:817-825), used in training
        self.masked_spec_embed = (
            nn.Parameter(torch.empty(cfg.hidden_size))
            if cfg.mask_time_prob > 0
            else None
        )
        self.encoder = Encoder(cfg)

    def forward(
        self,
        wav: torch.Tensor,  # [B, N]
        wav_mask: Optional[torch.Tensor] = None,  # [B, N] validity
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        output_hidden_states: bool = False,
    ):
        """``train=True`` applies dropout, SpecAugment and layerdrop, with
        every random draw from ``generator`` (required then). With
        ``output_hidden_states`` a third result: the encoder's
        ``num_layers + 1`` states (``Encoder``), each float32."""
        if train and generator is None:
            raise ValueError("train=True needs the train step's torch.Generator")
        gen = generator if train else None
        cfg = self.cfg
        param_dtype = self.feature_projection.projection.weight.dtype
        with _compute_context(wav.device, getattr(torch, cfg.dtype), param_dtype):
            features = self.feature_encoder(wav, wav_mask)
            frame_mask = None
            if wav_mask is not None:
                frame_lengths = feat_extract_output_lengths(wav_mask.sum(-1), cfg)
                frame_mask = _suffix_mask(frame_lengths, features.shape[1])
            x = self.feature_projection(features, gen)
            if gen is not None:
                x = self._spec_augment(x, frame_mask, gen)
            if self.insert_cls_token:
                b = x.shape[0]
                x = torch.cat([x.new_ones((b, 1, x.shape[2])), x], dim=1)
                if frame_mask is not None:
                    frame_mask = torch.cat([frame_mask.new_ones((b, 1)), frame_mask], dim=1)
            out = self.encoder(x, frame_mask, gen, output_hidden_states)
        if output_hidden_states:
            x, states = out
            return x.float(), frame_mask, [h.float() for h in states]
        return out.float(), frame_mask

    def _spec_augment(self, x, frame_mask, generator):
        """Time spans replaced by ``masked_spec_embed``, feature spans
        zeroed (:826-850), from uniforms drawn on ``generator``."""
        cfg = self.cfg
        b, t, h = x.shape
        if cfg.mask_time_prob > 0:
            time_mask = sample_span_mask(
                draw_row_uniform(generator, (b, t), x.device),
                cfg.mask_time_prob,
                cfg.mask_time_length,
                frame_mask.sum(-1) if frame_mask is not None else None,
            )
            x = torch.where(time_mask[:, :, None], self.masked_spec_embed.to(x.dtype), x)
        if cfg.mask_feature_prob > 0:
            feat_mask = sample_span_mask(
                draw_row_uniform(generator, (b, h), x.device),
                cfg.mask_feature_prob,
                cfg.mask_feature_length,
            )
            x = x * (~feat_mask)[:, None, :].to(x.dtype)
        return x


class Wav2Vec2LiteEncoder(nn.Module):
    """The conv feature encoder alone (the ``feature_encoder_only`` speaker
    model's backbone): raw waveform ``[B, N]`` -> (float32 features
    ``[B, T, conv_dim[-1]]``, frame mask ``[B, T]`` or None). No
    projection, SpecAugment, pos conv or transformer; nothing random, so
    ``train`` and ``generator`` change nothing. Its parameters are
    ``feature_encoder.*``, as the JAX module's (:879-901)."""

    def __init__(self, cfg: Wav2Vec2Config = BASE_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.feature_encoder = ConvFeatureEncoder(cfg)

    def forward(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        with _compute_context(wav.device, getattr(torch, cfg.dtype), self.feature_encoder.conv_0.weight.dtype):
            features = self.feature_encoder(wav, wav_mask)
        frame_mask = None
        if wav_mask is not None:
            frame_mask = _suffix_mask(feat_extract_output_lengths(wav_mask.sum(-1), cfg), features.shape[1])
        return features.float(), frame_mask


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator``, with the JAX package's
    initialisers: dense and conv kernels lecun-normal (truncated at two
    standard deviations), biases 0, norm scales 1, the pos-conv ``weight_v``
    uniform in +-1/sqrt(fan_in) with ``weight_g`` its per-tap norm,
    ``masked_spec_embed`` uniform in [0, 1), the AAM head's ``weights`` and
    the temporal gate's ``W`` xavier-normal (truncated, as flax's), the
    gate's ``b`` normal with std sqrt(2 / (F + 1)); any other module with a
    ``reset_parameters`` sets its own fixed values (``BatchNorm``), and a
    module with an ``after_init_parameters`` then overrides the values of its children
    it fixes (the speaker-CTC head's blank bias). Values are drawn in
    float32 and rounded to each parameter's dtype. The generator must be on the
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
        elif isinstance(m, (AAMSoftmaxHead, TemporalGate)):
            w = m.weights if isinstance(m, AAMSoftmaxHead) else m.W
            std = (2.0 / sum(w.shape)) ** 0.5 / 0.87962566103423978  # fan_avg
            draw(w, lambda x: nn.init.trunc_normal_(
                x, std=std, a=-2 * std, b=2 * std, generator=generator))
            if isinstance(m, TemporalGate):
                std = (2.0 / (m.b.shape[0] + 1)) ** 0.5
                draw(m.b, lambda x: nn.init.normal_(x, std=std, generator=generator))
        elif hasattr(m, "reset_parameters"):
            # A module of fixed initial values (BatchNorm); every drawn
            # parameter is one of the cases above.
            m.reset_parameters()
    for m in module.modules():  # after the children's values above
        if hasattr(m, "after_init_parameters"):
            m.after_init_parameters()
