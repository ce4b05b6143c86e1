"""Sample record of the port (copy of
``w2v2_speaker_tpu/data/samples.py::SpeakerSample`` :32)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np

__all__ = ["SpeakerSample"]


@dataclass
class SpeakerSample:
    key: str  # 'spk/yt/utt' id
    wav: np.ndarray  # [samples] float32
    ground_truth: int = -1  # speaker index; -1 when unknown
    meta: Dict[str, Any] = field(default_factory=dict)
