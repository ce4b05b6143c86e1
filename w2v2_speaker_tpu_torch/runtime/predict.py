"""Serving: bucketed embedding extraction and pair scoring.

Counterparts:

- ``extract_embeddings`` <- ``w2v2_speaker_tpu/runtime/experiment.py::
  extract_embeddings`` (:742): sort by length, right-pad each batch to a
  multiple of ``pad_to_multiple`` samples, pad the last batch with
  all-invalid rows, run the masked model, slice the rows back;
- ``read_pair_file`` <- ``w2v2_speaker_tpu/runtime/predict.py::
  read_pair_file`` (:74);
- ``score_pairs`` <- the pooled cosine of ``w2v2_speaker_tpu/eval/
  evaluator.py::CosineDistanceEvaluator`` (:176, ``_cosine_rowwise`` :83;
  no centering, no length-norm) followed by the ``(s + 1) / 2`` clip of
  ``w2v2_speaker_tpu/runtime/predict.py`` (:180).

The single-card port has no mesh, so ``num_devices`` and layer ensembles
are not here (ROADMAP Queue 1 items 6 and 10).
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..data.collate import collate_pad_right, pad_batch_rows
from ..data.samples import SpeakerSample
from ..device import DeviceLike, resolve_device

__all__ = ["EmbeddingSample", "extract_embeddings", "read_pair_file", "score_pairs"]


@dataclass
class EmbeddingSample:
    sample_id: str
    embedding: np.ndarray  # [D] float32


@torch.inference_mode()
def extract_embeddings(
    model,
    samples: Sequence[SpeakerSample],
    pad_to_multiple: int = 16000,
    batch_size: int = 8,
    device: DeviceLike = None,
) -> List[EmbeddingSample]:
    """Batched, bucketed, masked embedding extraction with
    ``model.compute_embedding(wav, mask)``. ``model`` must already live on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    out: List[EmbeddingSample] = []
    samples = sorted(samples, key=lambda s: s.wav.shape[-1])
    for i in range(0, len(samples), batch_size):
        chunk = samples[i : i + batch_size]
        batch = collate_pad_right(
            [s.wav for s in chunk], pad_to_multiple=pad_to_multiple, dtype=np.float32
        )
        padded = pad_batch_rows({"features": batch.values, "mask": batch.mask}, batch_size)
        wav = torch.from_numpy(padded["features"]).to(dev)
        mask = torch.from_numpy(padded["mask"]).to(dev)
        embs = model.compute_embedding(wav, mask).float().cpu().numpy()[: len(chunk)]
        out.extend(EmbeddingSample(s.key, embs[j]) for j, s in enumerate(chunk))
    return out


def read_pair_file(path: pathlib.Path) -> List[Tuple[str, str]]:
    """Trial pairs from ``<label> <a> <b>`` or ``<a> <b>`` lines."""
    pairs = []
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.strip().split(" ")
        if len(parts) == 3:
            pairs.append((parts[1], parts[2]))
        elif len(parts) == 2:
            pairs.append((parts[0], parts[1]))
    return pairs


def score_pairs(
    embeddings: Mapping[str, np.ndarray], pairs: Sequence[Tuple[str, str]]
) -> np.ndarray:
    """Row-wise cosine of each pair's embeddings (torch
    ``CosineSimilarity`` eps semantics), mapped to ``(s + 1) / 2`` and
    clipped to [0, 1]."""
    a = np.stack([np.asarray(embeddings[x], np.float32) for x, _ in pairs])
    b = np.stack([np.asarray(embeddings[y], np.float32) for _, y in pairs])
    denom = np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-8)
    cosine = (a * b).sum(axis=-1) / denom
    return np.clip((cosine + 1) / 2, 0, 1)
