"""Sample record and speaker-batch collation of the port: copies of
``w2v2_speaker_tpu/data/samples.py::SpeakerSample`` (:32) and
``collate_speaker_batch`` (:61)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .collate import collate_pad_right

__all__ = ["SpeakerSample", "collate_speaker_batch"]


@dataclass
class SpeakerSample:
    key: str  # 'spk/yt/utt' id
    wav: np.ndarray  # [samples] float32
    ground_truth: int = -1  # speaker index; -1 when unknown
    meta: Dict[str, Any] = field(default_factory=dict)


def collate_speaker_batch(
    samples: Sequence[SpeakerSample],
    pad_to_multiple: Optional[int] = None,
    bucket_boundaries: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Right-padded ``features`` [B, N] float32, ``labels`` [B] int32 and
    ``keys``; ``mask`` [B, N] only when some row is padded (fixed crops
    have none, and a missing mask means every sample is valid)."""
    batch = collate_pad_right(
        [s.wav for s in samples], pad_to_multiple=pad_to_multiple,
        bucket_boundaries=bucket_boundaries, dtype=np.float32,
    )
    out = {
        "features": batch.values,
        "labels": np.asarray([s.ground_truth for s in samples], np.int32),
        "keys": [s.key for s in samples],
    }
    if not batch.mask.all():
        out["mask"] = batch.mask
    return out
