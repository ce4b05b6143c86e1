"""Sample records and batch collation of the port: copies of
``w2v2_speaker_tpu/data/samples.py::SpeakerSample`` (:32), ``PairedSample``
(:40), ``SpeechSample`` (:49), ``collate_speaker_batch`` (:61),
``collate_paired_batch`` (:87) and ``collate_speech_batch`` (:120)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .collate import collate_pad_right

__all__ = [
    "PairedSample", "SpeakerSample", "SpeechSample", "collate_paired_batch", "collate_speaker_batch",
    "collate_speech_batch",
]


@dataclass
class SpeakerSample:
    key: str  # 'spk/yt/utt' id
    wav: np.ndarray  # [samples] float32
    ground_truth: int = -1  # speaker index; -1 when unknown
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PairedSample:
    primary_key: str
    primary_wav: np.ndarray
    secondary_key: str
    secondary_wav: np.ndarray
    ground_truth: int  # 1 same speaker, 0 different


@dataclass
class SpeechSample:
    key: str  # LibriSpeech '<spk>-<chapter>-<utt>'
    wav: np.ndarray
    transcription: str
    tokens: Optional[np.ndarray] = None  # int CTC targets
    speaker_idx: Optional[int] = None  # the speaker's class, when asked for


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


def collate_paired_batch(
    samples: Sequence[PairedSample],
    pad_to_multiple: Optional[int] = None,
    bucket_boundaries: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Each side right-padded on its own: ``features_a`` / ``features_b``
    [B, N] float32, ``mask_a`` / ``mask_b`` only where some row of that
    side is padded, ``labels`` [B] int32 and ``keys`` (primary, secondary)."""
    sides = [
        collate_pad_right([getattr(s, f"{side}_wav") for s in samples], pad_to_multiple=pad_to_multiple,
                          bucket_boundaries=bucket_boundaries, dtype=np.float32)
        for side in ("primary", "secondary")
    ]
    out = {
        "features_a": sides[0].values,
        "features_b": sides[1].values,
        "labels": np.asarray([s.ground_truth for s in samples], np.int32),
        "keys": [(s.primary_key, s.secondary_key) for s in samples],
    }
    for name, side in zip(("mask_a", "mask_b"), sides):
        if not side.mask.all():
            out[name] = side.mask
    return out


def collate_speech_batch(
    samples: Sequence[SpeechSample],
    pad_to_multiple: Optional[int] = None,
    label_pad_to_multiple: int = 8,
) -> Dict[str, Any]:
    """Right-padded ``features`` [B, N] float32 and ``mask`` [B, N] (always),
    the token ids 0-padded to a multiple of ``label_pad_to_multiple`` as
    ``labels`` [B, S] int32 with ``label_lengths`` [B], the host-only
    ``transcriptions`` and ``keys``, and ``speaker_labels`` [B] int32 when
    every sample has a speaker index."""
    batch = collate_pad_right([s.wav for s in samples], pad_to_multiple=pad_to_multiple, dtype=np.float32)
    labels = collate_pad_right([np.asarray(s.tokens, np.int32) for s in samples], value=0,
                               pad_to_multiple=label_pad_to_multiple, dtype=np.int32)
    out = {
        "features": batch.values,
        "mask": batch.mask,
        "labels": labels.values,
        "label_lengths": labels.lengths,
        "transcriptions": [s.transcription for s in samples],
        "keys": [s.key for s in samples],
    }
    if all(s.speaker_idx is not None for s in samples):
        out["speaker_labels"] = np.asarray([s.speaker_idx for s in samples], np.int32)
    return out
