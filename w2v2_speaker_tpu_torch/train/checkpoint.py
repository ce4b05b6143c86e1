"""Checkpointing of the train state, and weights-only loading for warm
starts and serving.

``CheckpointManager`` is the counterpart of
``w2v2_speaker_tpu/train/checkpoint.py::CheckpointManager`` (:62), with
``resolve_checkpoint_path`` (:33): after each validation it writes
``last`` and keeps the ``top_k`` lowest checkpoints on the monitored
metric (``val_eer``, or ``val_wer`` for the speech task) in directories
named ``step{step:08d}_{monitor}={metric:.4f}``, recorded
in the same ``index.json`` (best entries in order, ``last`` with its step
and epoch). Each directory holds ``state.pt``, a torch file of
``TrainState.state_dict()`` (the step, the model, the optimizer transform's
state, the step generator's state) and the epoch, in place of the JAX
package's orbax tree, so a resumed run continues the dropout stream. In a
data-parallel run (a ``mesh``) rank 0 alone writes, and every rank waits at
a barrier after each save and then reads the index anew; every rank
restores. The replicas are equal, so a checkpoint holds the one model,
and a run at one world size resumes from it at another.

``load_params`` is the counterpart of ``load_params`` (:251): a checkpoint's leaves are grafted into the model's current
parameters, and a leaf that the checkpoint lacks, or holds in another
shape, keeps its current value (a 5994-way head loaded into a 2-way
predict model keeps its initialisation). The JAX package writes orbax
checkpoints, which need JAX to read; ``tools/export_jax_params.py`` turns
one into an ``.npz`` of the flattened params tree (``/``-joined keys) and,
under ``batch_stats/``, of its ``batch_stats`` collection (the running
statistics of ``attentive`` pooling's BatchNorm), which ``load_params``
converts with ``convert.params_from_jax`` into parameters and buffers. A
torch ``state_dict`` file of the port's own model loads as it is.

Unlike the JAX package, a graft in which no backbone entry matches raises:
a file whose names differ (a ``module.`` prefix, a wrapper dict, an HF
file given as the model's checkpoint) would otherwise leave the whole
model at its initialisation without a word. Each graft prints how many
entries it loaded and how many kept their values.
"""

from __future__ import annotations

import json
import pathlib
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.convert import params_from_jax
from ..parallel.mesh import barrier
from .state import TrainState

__all__ = [
    "CheckpointManager", "MONITORS", "STATE_FILE", "graft", "graft_into", "load_params", "resolve_checkpoint_path",
    "unflatten",
]

STATE_FILE = "state.pt"
MONITORS = ("val_eer", "val_wer")  # the metrics best-k may rank, lowest first


def resolve_checkpoint_path(path) -> pathlib.Path:
    """``<dir>/best`` as the best entry of ``<dir>/index.json`` (no
    directory is named ``best``), else ``last`` when the index has one;
    any other path as it is."""
    p = pathlib.Path(path)
    if p.exists() or p.name != "best":
        return p
    idx = p.parent / "index.json"
    if idx.exists():
        index = json.loads(idx.read_text())
        entries = index.get("best") or []
        if entries:
            return p.parent / entries[0]["name"]
        if index.get("last") and (p.parent / "last").exists():
            return p.parent / "last"
    return p


def _load_state(directory: pathlib.Path) -> Dict:
    return torch.load(directory / STATE_FILE, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Best-k and last checkpoints of a ``TrainState``: keeps the ``top_k``
    lowest values of ``monitor`` (the validation EER, or WER), and always
    writes ``last``, which resume reads."""

    def __init__(self, directory, monitor: str = "val_eer", top_k: int = 1, mesh=None):
        if monitor not in MONITORS:
            raise ValueError(f"monitor {monitor!r} is not one of {MONITORS}")
        self.monitor = monitor
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.mesh = mesh
        self._writer = mesh is None or mesh.is_main
        self._index_path = self.dir / "index.json"
        self._index: Dict = (json.loads(self._index_path.read_text()) if self._index_path.exists()
                             else {"best": [], "last": None})

    def _write_index(self) -> None:
        self._index_path.write_text(json.dumps(self._index, indent=2))

    def _save(self, name: str, state: TrainState, epoch: Optional[int]) -> None:
        path = self.dir / name
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save({**state.state_dict(), "epoch": epoch}, path / STATE_FILE)

    def save_step(self, state: TrainState, metrics: Optional[Dict[str, float]] = None,
                  epoch: Optional[int] = None) -> None:
        """After a validation: write ``last`` and update the best-k set.
        ``epoch`` (the epoch in progress) rides the index, so a resumed run
        continues its epoch count. Rank 0 writes; every rank leaves after
        the save, with the index on disk."""
        if not self._writer:
            barrier(self.mesh)
            self._index = json.loads(self._index_path.read_text())
            return
        self._save_step(state, metrics, epoch)
        barrier(self.mesh)

    def _save_step(self, state: TrainState, metrics: Optional[Dict[str, float]], epoch: Optional[int]) -> None:
        step = int(state.step)
        self._save("last", state, epoch)
        self._index["last"] = {"step": step}
        if epoch is not None:
            self._index["last"]["epoch"] = int(epoch)
        metric = None if metrics is None else metrics.get(self.monitor)
        if metric is not None and np.isfinite(metric):
            name = f"step{step:08d}_{self.monitor}={metric:.4f}"
            entries = self._index["best"]
            worst = max((e["metric"] for e in entries), default=np.inf)
            # a second validation at the same step names the same directory:
            # one directory, one entry
            if not any(e["name"] == name for e in entries) and (len(entries) < self.top_k or metric < worst):
                self._save(name, state, epoch)
                entries.append({"name": name, "metric": float(metric), "step": step})
                entries.sort(key=lambda e: e["metric"])
                while len(entries) > self.top_k:
                    dropped = self.dir / entries.pop()["name"]
                    if dropped.exists():
                        shutil.rmtree(dropped)
        self._write_index()

    @property
    def best_path(self) -> Optional[pathlib.Path]:
        entries = self._index["best"]
        if not entries:
            return self.dir / "last" if self._index["last"] else None
        return self.dir / entries[0]["name"]

    def last_epoch(self) -> Optional[int]:
        """The epoch recorded with ``last`` (None when the index has none)."""
        ep = (self._index.get("last") or {}).get("epoch")
        return None if ep is None else int(ep)

    def restore(self, state: TrainState, name: str = "best") -> TrainState:
        """Load checkpoint ``name`` ("best", "last" or an entry's name) into
        ``state`` in place and return it."""
        path = self.best_path if name == "best" else self.dir / name
        if path is None or not (path / STATE_FILE).exists():
            raise FileNotFoundError(f"no checkpoint at {path}")
        state.load_state_dict(_load_state(path))
        return state

    def average_best(self, state: TrainState, k: int) -> TrainState:
        """``state`` with the uniform average of the best-k checkpoints'
        floating-point model entries (summed in float64); everything else
        (step, optimizer, generator, integer entries) from the best one.
        With fewer than 2 best entries, the best checkpoint alone."""
        entries = self._index["best"][: max(int(k), 1)]
        if len(entries) < 2:
            print(f"checkpoint averaging: requested {k} but only {len(entries)} best checkpoint(s) "
                  f"recorded (is trainer.save_top_k >= {k}?) — restoring the single best")
            return self.restore(state, name="best")
        best = _load_state(self.dir / entries[0]["name"])
        acc = {n: v.double() for n, v in best["model"].items() if v.is_floating_point()}
        for e in entries[1:]:  # one more state in memory at a time
            for n, v in _load_state(self.dir / e["name"])["model"].items():
                if n in acc:
                    acc[n] += v.double()
        best["model"] = {n: (acc[n] / len(entries)).to(v.dtype) if n in acc else v
                         for n, v in best["model"].items()}
        print(f"checkpoint averaging: {len(entries)} best checkpoints ({[e['name'] for e in entries]})")
        state.load_state_dict(best)
        return state

_STACKED = "encoder/layers/block/"
_BATCH_STATS = "batch_stats/"  # the .npz prefix of the checkpoint's batch_stats leaves


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
    cfg = getattr(model, "cfg", None)
    stacked = [v.shape[0] for k, v in flat.items() if _STACKED in k]
    if stacked and stacked[0] != getattr(getattr(cfg, "w2v2", cfg), "num_layers", None):
        # the stacked [L, ...] leaves are of another shape: they keep their
        # current values, as the JAX package's graft keeps them
        flat = {k: v for k, v in flat.items() if _STACKED not in k}
    stats = {k.removeprefix(_BATCH_STATS): v for k, v in flat.items() if k.startswith(_BATCH_STATS)}
    params = {k: v for k, v in flat.items() if not k.startswith(_BATCH_STATS)}
    return params_from_jax(unflatten(params), cfg, unflatten(stats))


def load_params(path, model: nn.Module) -> nn.Module:
    """Graft the weights of ``path`` into ``model`` in place: an ``.npz``
    from ``tools/export_jax_params.py``, a torch ``state_dict`` file
    (``torch.save(model.state_dict(), ...)``), or a ``CheckpointManager``
    directory (``<dir>/best`` resolves through its index). Raises when no
    entry of the backbone (``model.wav2vec2``) is in the file. Returns
    ``model``."""
    path = resolve_checkpoint_path(path)
    if path.is_dir():
        if not (path / STATE_FILE).exists():
            raise ValueError(
                f"{path} is a directory without {STATE_FILE} (an orbax checkpoint of the JAX "
                "package?): export it first with tools/export_jax_params.py"
            )
        loaded = _load_state(path)["model"]
    elif path.suffix == ".npz":
        loaded = _npz_state_dict(path, model)
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
    required = "wav2vec2." if isinstance(getattr(model, "wav2vec2", None), nn.Module) else ""
    return graft_into(model, loaded, path, required)

