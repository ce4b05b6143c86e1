"""Weight bridge from the JAX package's parameter tree to the port.

``params_from_jax(params, cfg, batch_stats)`` takes the flax ``params``
tree of ``w2v2_speaker_tpu``'s ``Wav2Vec2Model``, ``Wav2Vec2SpeakerModel``
(with the full backbone or, under ``feature_encoder_only``, the conv stack
alone), ``Wav2Vec2PairedModel``, ``Wav2Vec2SpeechModel``,
``Wav2Vec2MultitaskModel``, ``FbankFrontend`` over ``XVectorModel`` or
``EcapaModel``, ``Wav2SpkModel`` or ``DummyModel`` as nested dicts of
numpy arrays (what ``jax.device_get(variables["params"])`` gives), and
optionally the ``batch_stats`` collection beside it, and returns the
``state_dict`` of the port's module of the same name. It imports neither
jax nor flax. The rules:

- the stacked ``[L, ...]`` layer parameters under ``encoder/layers/block``
  become ``encoder.layers.{i}``;
- dense kernels ``[in, out]`` become ``weight`` ``[out, in]``;
- conv kernels ``[k, in, out]`` become ``weight`` ``[out, in, k]``;
- norm ``scale`` becomes ``weight``;
- ``weight_v`` / ``weight_g`` (already in torch layout), biases,
  ``masked_spec_embed``, the AAM head's ``weights`` ``[classes, D]`` and
  the temporal gate's ``W`` (applied as ``[out, in]``) pass through;
- a ``batch_stats`` leaf ``mean`` / ``var`` becomes the ``running_mean`` /
  ``running_var`` buffer of the ``BatchNorm`` at its path.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["params_from_jax"]

_STACKED = ("encoder", "layers", "block")
_RUNNING = {"mean": "running_mean", "var": "running_var"}


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
    params: Mapping, cfg=None, batch_stats: Optional[Mapping] = None,
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) for a flax params
    tree and its ``batch_stats``; load it with
    ``module.load_state_dict(..., strict=True)``. ``cfg`` is the model's
    config (a ``Wav2Vec2Config`` or one holding it as ``w2v2``), read for
    the layer count of a stacked encoder; a tree without one needs none."""
    num_layers = getattr(getattr(cfg, "w2v2", cfg), "num_layers", None)
    out: Dict[str, torch.Tensor] = {}
    stats = [(path[:-1] + (_RUNNING[path[-1]],), x) for path, x in _leaves(batch_stats or {})]
    for path, x in [*_leaves(params), *stats]:
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
