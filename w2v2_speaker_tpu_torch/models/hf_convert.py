"""HuggingFace wav2vec2 checkpoints -> the port's ``Wav2Vec2Model``.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2_convert.py``:
``hf_state_dict_to_torch`` maps a HF ``Wav2Vec2Model`` (or
``Wav2Vec2ForCTC``, keys under ``wav2vec2.``) state dict straight to the
port's ``state_dict``, as ``hf_state_dict_to_flax`` (:29) maps it to the
flax tree, and ``load_hf_checkpoint`` (:197) reads a local file. The rules:

- ``feature_extractor.conv_layers.{i}.conv`` -> ``feature_encoder.conv_{i}``
  (bias only where the config has conv bias); the conv-0 norm of the
  group-norm layout -> ``feature_encoder.group_norm``, every other conv norm
  -> ``feature_encoder.layer_norm_{i}``;
- q, k and v of each layer are concatenated along the output rows into the
  fused ``qkv_proj``;
- ``feed_forward.{intermediate,output}_dense`` lose their prefix;
- the pos conv's weight norm arrives as ``weight_g`` / ``weight_v`` or, from
  torch >= 2, as ``parametrizations.weight.original0`` / ``original1``;
  ``weight_g`` becomes ``[1, 1, k]``;
- ``masked_spec_embed`` is taken where the config masks time.

``.bin`` / ``.pt`` files are read with ``torch.load(weights_only=True)``,
``.safetensors`` files by ``read_safetensors`` (no ``safetensors``
package needed). Nothing here touches the network.
"""

from __future__ import annotations

import json
import pathlib
import struct
from typing import Dict, Mapping

import numpy as np
import torch

from .wav2vec2 import BASE_CONFIG, Wav2Vec2Config

__all__ = ["hf_state_dict_to_torch", "load_hf_checkpoint", "read_safetensors"]

# safetensors dtype names -> numpy; BF16 is read as its bits and widened
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array: an 8-byte
    little-endian header length, a JSON header of ``{name: {dtype, shape,
    data_offsets}}``, then the raw little-endian buffers. BF16 tensors come
    back as float32 (exactly: bf16 is the top half of a float32)."""
    data = pathlib.Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = body[begin:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(_SAFETENSORS_DTYPES[info["dtype"]]).newbyteorder("<"))
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def hf_state_dict_to_torch(
    state_dict: Mapping[str, object], cfg: Wav2Vec2Config = BASE_CONFIG
) -> Dict[str, torch.Tensor]:
    """The port's ``Wav2Vec2Model`` state dict (float32 CPU tensors) of a HF
    wav2vec2 state dict (torch tensors or numpy arrays, keys with or
    without a leading ``wav2vec2.``)."""
    sd = {k.removeprefix("wav2vec2."): v for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_dim)):
        src = f"feature_extractor.conv_layers.{i}"
        out[f"feature_encoder.conv_{i}.weight"] = _f32(sd[f"{src}.conv.weight"])
        if cfg.conv_bias and f"{src}.conv.bias" in sd:
            out[f"feature_encoder.conv_{i}.bias"] = _f32(sd[f"{src}.conv.bias"])
        if f"{src}.layer_norm.weight" in sd:
            norm = ("feature_encoder.group_norm" if i == 0 and cfg.feat_extract_norm == "group"
                    else f"feature_encoder.layer_norm_{i}")
            out[f"{norm}.weight"] = _f32(sd[f"{src}.layer_norm.weight"])
            out[f"{norm}.bias"] = _f32(sd[f"{src}.layer_norm.bias"])
    for name in ("layer_norm.weight", "layer_norm.bias", "projection.weight", "projection.bias"):
        out[f"feature_projection.{name}"] = _f32(sd[f"feature_projection.{name}"])
    if "masked_spec_embed" in sd and cfg.mask_time_prob > 0:
        out["masked_spec_embed"] = _f32(sd["masked_spec_embed"])

    pos = "encoder.pos_conv_embed.conv"
    if f"{pos}.weight_g" in sd:
        g, v = sd[f"{pos}.weight_g"], sd[f"{pos}.weight_v"]
    else:  # torch >= 2 parametrizations
        g = sd[f"{pos}.parametrizations.weight.original0"]
        v = sd[f"{pos}.parametrizations.weight.original1"]
    out["encoder.pos_conv_embed.weight_g"] = _f32(g).reshape(1, 1, -1)
    out["encoder.pos_conv_embed.weight_v"] = _f32(v)
    out["encoder.pos_conv_embed.bias"] = _f32(sd[f"{pos}.bias"])
    out["encoder.layer_norm.weight"] = _f32(sd["encoder.layer_norm.weight"])
    out["encoder.layer_norm.bias"] = _f32(sd["encoder.layer_norm.bias"])

    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"encoder.layers.{i}"
        for leaf in ("weight", "bias"):
            out[f"{dst}.attention.qkv_proj.{leaf}"] = torch.cat(
                [_f32(sd[f"{src}.attention.{p}_proj.{leaf}"]) for p in ("q", "k", "v")])
            out[f"{dst}.attention.out_proj.{leaf}"] = _f32(sd[f"{src}.attention.out_proj.{leaf}"])
            for dense in ("intermediate_dense", "output_dense"):
                out[f"{dst}.{dense}.{leaf}"] = _f32(sd[f"{src}.feed_forward.{dense}.{leaf}"])
            for norm in ("layer_norm", "final_layer_norm"):
                out[f"{dst}.{norm}.{leaf}"] = _f32(sd[f"{src}.{norm}.{leaf}"])
    return out


def load_hf_checkpoint(path, cfg: Wav2Vec2Config = BASE_CONFIG) -> Dict[str, torch.Tensor]:
    """Read a local HF checkpoint file (``.safetensors``, or a ``.bin`` /
    ``.pt`` torch state dict, possibly under ``"state_dict"``) and convert
    it with ``hf_state_dict_to_torch``."""
    path = str(path)
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return hf_state_dict_to_torch(sd, cfg)
