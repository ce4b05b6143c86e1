"""Weight bridge from the JAX package's parameter tree to the port.

``params_from_jax(params, cfg)`` takes the flax ``params`` tree of
``w2v2_speaker_tpu``'s ``Wav2Vec2Model`` or ``Wav2Vec2SpeakerModel`` as
nested dicts of numpy arrays (what ``jax.device_get(variables["params"])``
gives) and returns the ``state_dict`` of the port's module of the same
name. It imports neither jax nor flax. The rules:

- the stacked ``[L, ...]`` layer parameters under ``encoder/layers/block``
  become ``encoder.layers.{i}``;
- dense kernels ``[in, out]`` become ``weight`` ``[out, in]``;
- conv kernels ``[k, in, out]`` become ``weight`` ``[out, in, k]``;
- norm ``scale`` becomes ``weight``;
- ``weight_v`` / ``weight_g`` (already in torch layout), biases and
  ``masked_spec_embed`` pass through.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from .wav2vec2 import Wav2Vec2Config
from .wav2vec2_speaker import Wav2Vec2SpeakerConfig

__all__ = ["params_from_jax"]

_STACKED = ("encoder", "layers", "block")


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _torch_leaf(path: Tuple[str, ...], x: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        leaf = "weight"
        x = x.T if x.ndim == 2 else x.transpose(2, 1, 0)
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*mods, leaf]), x


def params_from_jax(
    params: Mapping,
    cfg: Union[Wav2Vec2Config, Wav2Vec2SpeakerConfig],
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) for a flax params
    tree; load it with ``module.load_state_dict(..., strict=True)``."""
    num_layers = getattr(cfg, "w2v2", cfg).num_layers
    out: Dict[str, torch.Tensor] = {}
    for path, x in _leaves(params):
        at = next(
            (i for i in range(len(path)) if path[i : i + 3] == _STACKED), None
        )
        if at is None:
            items = [_torch_leaf(path, x)]
        else:
            if x.shape[0] != num_layers:
                raise ValueError(
                    f"{'/'.join(path)}: {x.shape[0]} stacked layers, config "
                    f"has {num_layers}"
                )
            items = [
                _torch_leaf(path[:at] + ("encoder", "layers", str(i)) + path[at + 3 :], x[i])
                for i in range(num_layers)
            ]
        for name, value in items:
            out[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out
