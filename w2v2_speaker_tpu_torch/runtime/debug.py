"""Debug observability: the port's copy of ``w2v2_speaker_tpu/runtime/debug.py``.

- ``debug_tensor_content`` (:29): min / max / mean / std over the finite
  values, NaN and inf counts, printed and optionally saved beside the raw
  array (``<name>.npy`` and ``<name>.txt``);
- ``dump_first_batch`` (:57): every entry of a batch (arrays through
  ``debug_tensor_content`` as ``batch_<key>``, the rest as ``repr`` text),
  for the first training batch of a run and for the batches of a failed
  step;
- ``PipelineDebugCapture`` (:69): per-stage artifacts of the first
  ``max_samples`` pipeline samples, each in a directory of numbered stages
  (``00_original``, ``01_augment_<effect>``, ``.._chunk0``,
  ``.._normalize0``; the speech pipeline's ``transcription`` and
  ``tokens``), as ``.npy`` + stats ``.txt`` + a 16-bit ``.wav`` render, or
  ``.txt`` for text; thread-safe, with the JAX module's ownership rules;
- ``batch_gradient_verification`` (:166): the cross-batch leakage probe of
  an embedding function (in eval mode: replace one row with fresh random
  content, and no other row's embedding may move);
- ``model_summary`` (:208): parameter counts per top-level submodule of a
  ``torch.nn.Module`` and their total (buffers, such as BatchNorm running
  statistics, are not parameters, as ``batch_stats`` are not flax
  ``params``).
"""

from __future__ import annotations

import pathlib
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["PipelineDebugCapture", "batch_gradient_verification", "debug_tensor_content", "dump_first_batch",
           "model_summary"]


def debug_tensor_content(tensor, name: str, save_dir: Optional[pathlib.Path] = None,
                         print_stats: bool = True) -> Dict[str, Any]:
    arr = np.asarray(tensor)
    finite = arr[np.isfinite(arr)] if arr.size else arr
    stats = {
        "shape": list(arr.shape),
        "dtype": str(arr.dtype),
        "min": float(finite.min()) if finite.size else float("nan"),
        "max": float(finite.max()) if finite.size else float("nan"),
        "mean": float(finite.mean()) if finite.size else float("nan"),
        "std": float(finite.std()) if finite.size else float("nan"),
        "num_nan": int(np.isnan(arr).sum()),
        "num_inf": int(np.isinf(arr).sum()),
    }
    if print_stats:
        print(f"[debug] {name}: {stats}")
    if save_dir is not None:
        save_dir = pathlib.Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        np.save(save_dir / f"{name}.npy", arr)
        (save_dir / f"{name}.txt").write_text(repr(stats))
    return stats


def dump_first_batch(batch: Dict[str, Any], save_dir: pathlib.Path) -> None:
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    for key, value in batch.items():
        if hasattr(value, "shape"):
            debug_tensor_content(value, f"batch_{key}", save_dir, print_stats=True)
        else:
            (save_dir / f"batch_{key}.txt").write_text(repr(value))


class PipelineDebugCapture:
    """Per-stage debug artifacts of the first ``max_samples`` pipeline
    samples, each under ``out_dir / <key with / as _>``.

    A sample's stage chain runs in one call on one thread, so the first
    thread to record a key owns its chain: the same key recorded at once on
    another thread (pair and triplet sampling can draw a key twice an
    epoch) is ignored, and a second ``original`` on the owner thread (a
    second pass over the key: the example batch drawn before training, a
    later epoch) closes the key, so that no stage is written twice."""

    def __init__(self, out_dir: pathlib.Path, max_samples: int = 4, sample_rate: int = 16000):
        self.out_dir = pathlib.Path(out_dir)
        self.max_samples = int(max_samples)
        self.sample_rate = int(sample_rate)
        self._stage_idx: Dict[str, int] = {}
        self._owner: Dict[str, int] = {}
        self._done: set = set()
        self._lock = threading.Lock()

    def wants(self, key: str) -> bool:
        with self._lock:
            return key in self._stage_idx or len(self._stage_idx) < self.max_samples

    def _next_stage(self, key: str, stage: str) -> Optional[int]:
        tid = threading.get_ident()
        with self._lock:
            if key in self._done:
                return None
            if key not in self._stage_idx:
                if len(self._stage_idx) >= self.max_samples:
                    return None
                self._stage_idx[key] = 0
                self._owner[key] = tid
            elif self._owner.get(key) != tid:
                return None
            elif stage == "original" and self._stage_idx[key] > 0:
                self._done.add(key)
                return None
            idx = self._stage_idx[key]
            self._stage_idx[key] += 1
        return idx

    def record(self, key: str, stage: str, wav, render_wav: bool = True) -> None:
        idx = self._next_stage(key, stage)
        if idx is None:
            return
        arr = np.asarray(wav)
        d = self.out_dir / key.replace("/", "_")
        name = f"{idx:02d}_{stage}"
        debug_tensor_content(arr, name, d, print_stats=False)
        if render_wav and arr.ndim == 1 and arr.size:
            from ..data.io import write_wav

            peak = float(np.abs(arr).max()) or 1.0
            write_wav(d / f"{name}.wav", (arr / max(peak, 1.0)).astype(np.float32), self.sample_rate)

    def record_text(self, key: str, stage: str, text: str) -> None:
        """A text stage (the speech pipeline's transcription)."""
        idx = self._next_stage(key, stage)
        if idx is None:
            return
        d = self.out_dir / key.replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{idx:02d}_{stage}.txt").write_text(str(text) + "\n")


def batch_gradient_verification(embed_fn: Callable, features: np.ndarray, mask: Optional[np.ndarray] = None,
                                perturb_index: int = 0) -> bool:
    """Cross-batch leakage probe (the reference's BatchGradientVerification
    role): ``embed_fn(features, mask)`` -> ``[B, ...]`` numpy embeddings,
    called in eval mode, where a correct model embeds each row on
    its own. Row ``perturb_index`` is replaced with fresh random content
    (affine changes are undone by per-utterance normalisation and
    permutations by statistics pooling); every other row must keep its
    embedding within 1e-5 and the replaced row must change. Returns True,
    or raises ``AssertionError``."""
    base = np.asarray(embed_fn(features, mask))
    perturbed = np.array(features)
    rng = np.random.default_rng(0)
    scale = float(np.abs(perturbed[perturb_index]).mean() + 1e-3)
    perturbed[perturb_index] = rng.normal(scale=scale, size=perturbed[perturb_index].shape).astype(perturbed.dtype)
    out = np.asarray(embed_fn(perturbed, mask))
    changed = np.abs(out - base).reshape(out.shape[0], -1).max(axis=1)
    others = np.delete(changed, perturb_index)
    if (others > 1e-5).any():
        raise AssertionError(
            f"cross-batch leakage: perturbing sample {perturb_index} changed {int((others > 1e-5).sum())} other "
            f"samples (max delta {others.max():.3e})")
    if changed[perturb_index] == 0.0:
        raise AssertionError("perturbation did not affect the perturbed sample — the check is vacuous")
    return True


def model_summary(model: torch.nn.Module) -> str:
    """Parameter counts per top-level submodule (a parameter of the model
    itself counts under its own name) and the total."""
    counts: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        counts[top] = counts.get(top, 0) + p.numel()
    lines = [f"  {name:<30s} {count:>14,d}" for name, count in sorted(counts.items())]
    lines.append(f"  {'TOTAL':<30s} {sum(counts.values()):>14,d}")
    return "model parameters:\n" + "\n".join(lines)
