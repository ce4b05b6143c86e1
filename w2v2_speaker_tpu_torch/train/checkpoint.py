"""Weights-only loading for warm starts and serving.

Counterpart of ``w2v2_speaker_tpu/train/checkpoint.py::load_params``
(:251): a checkpoint's leaves are grafted into the model's current
parameters, and a leaf that the checkpoint lacks, or holds in another
shape, keeps its current value (a 5994-way head loaded into a 2-way
predict model keeps its initialisation). The JAX package writes orbax
checkpoints, which need JAX to read; ``tools/export_jax_params.py`` turns
one into an ``.npz`` of the flattened params tree (``/``-joined keys),
which ``load_params`` converts with ``convert.params_from_jax``. A torch
``state_dict`` file of the port's own model loads as it is.

Unlike the JAX package, a graft in which no backbone entry matches raises:
a file whose names differ (a ``module.`` prefix, a wrapper dict, an HF
file given as the model's checkpoint) would otherwise leave the whole
model at its initialisation without a word. Each graft prints how many
entries it loaded and how many kept their values.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.convert import params_from_jax

__all__ = ["graft", "graft_into", "load_params", "unflatten"]

_STACKED = "encoder/layers/block/"


def graft(current: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``current`` with every entry that ``loaded`` holds in the same shape
    replaced by it (cast to the current entry's dtype and device)."""
    return {
        name: loaded[name].to(value.dtype).to(value.device)
        if name in loaded and tuple(loaded[name].shape) == tuple(value.shape) else value
        for name, value in current.items()
    }


def graft_into(module: nn.Module, loaded: Mapping[str, torch.Tensor], source, required: str = "") -> nn.Module:
    """Graft ``loaded`` into ``module``'s parameters and buffers in place
    (``graft``), print how many entries were loaded and kept, and raise
    when no entry whose name starts with ``required`` was loaded."""
    current = module.state_dict()
    hits = {n for n, v in current.items() if n in loaded and tuple(loaded[n].shape) == tuple(v.shape)}
    if not any(n.startswith(required) for n in hits):
        raise ValueError(
            f"{source}: none of the model's {required + '* ' if required else ''}entries is in the file "
            f"under its name and shape (the file's first names: {sorted(loaded)[:3]}; the model's: "
            f"{[n for n in current if n.startswith(required)][:3]})"
        )
    module.load_state_dict(graft(current, loaded))
    kept = sorted(set(current) - hits)
    print(f"{source}: loaded {len(hits)} of {len(current)} entries; kept at init {len(kept)}"
          + (f" ({', '.join(kept[:4])}{', ...' if len(kept) > 4 else ''})" if kept else ""))
    return module


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: Dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _npz_state_dict(path: pathlib.Path, model: nn.Module) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    cfg = model.cfg
    layers = cfg.w2v2.num_layers if hasattr(cfg, "w2v2") else cfg.num_layers
    stacked = [v.shape[0] for k, v in flat.items() if _STACKED in k]
    if stacked and stacked[0] != layers:
        # the stacked [L, ...] leaves are of another shape: they keep their
        # current values, as the JAX package's graft keeps them
        flat = {k: v for k, v in flat.items() if _STACKED not in k}
    return params_from_jax(unflatten(flat), cfg)


def load_params(path, model: nn.Module) -> nn.Module:
    """Graft the weights of ``path`` into ``model`` in place: an ``.npz``
    from ``tools/export_jax_params.py``, or a torch ``state_dict`` file
    (``torch.save(model.state_dict(), ...)``). Raises when no entry of the
    backbone (``model.wav2vec2``) is in the file. Returns ``model``."""
    path = pathlib.Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): "
            "export it first with tools/export_jax_params.py"
        )
    if path.suffix == ".npz":
        loaded = _npz_state_dict(path, model)
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
    required = "wav2vec2." if isinstance(getattr(model, "wav2vec2", None), nn.Module) else ""
    return graft_into(model, loaded, path, required)

