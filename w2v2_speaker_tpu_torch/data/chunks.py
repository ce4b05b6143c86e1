"""Audio chunk selection: the port's copy of
``w2v2_speaker_tpu/data/chunks.py`` (``SelectionStrategy`` :19,
``ChunkSelector`` :31).

Strategies start / end / random / random_contiguous / contiguous over the
last (time) axis of a waveform, and ``none`` for the full utterance. Random
offsets come from an explicit ``numpy.random.Generator``, drawn as the JAX
package draws them, so both packages crop the same samples at one seed.
"""

from __future__ import annotations

import enum
from typing import List, Optional

import numpy as np

__all__ = ["SelectionStrategy", "ChunkSelector"]


class SelectionStrategy(str, enum.Enum):
    start = "start"
    end = "end"
    random = "random"
    random_contiguous = "random_contiguous"
    contiguous = "contiguous"
    none = "none"  # the full utterance (chunk_length_sec null)


class ChunkSelector:
    def __init__(self, strategy: SelectionStrategy | str, chunk_length_sec: Optional[float],
                 sample_rate: int = 16000):
        self.strategy = SelectionStrategy.none if chunk_length_sec is None else SelectionStrategy(strategy)
        self.chunk_size = 0 if chunk_length_sec is None else round(sample_rate * chunk_length_sec)
        self.sample_rate = sample_rate

    def __call__(self, wav: np.ndarray, rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
        """The selected chunk(s) along the last axis: one array for every
        strategy but ``contiguous``, which returns all whole chunks."""
        n, c, s = wav.shape[-1], self.chunk_size, self.strategy
        if s == SelectionStrategy.none:
            return [wav]
        if s == SelectionStrategy.start:
            return [wav[..., :c]]
        if s == SelectionStrategy.end:
            return [wav[..., -c:]]
        if s == SelectionStrategy.random:
            if c >= n:
                return [wav]
            if rng is None:
                raise ValueError("random strategy requires an rng")
            start = int(rng.integers(0, n - c))
            return [wav[..., start : start + c]]
        num_chunks = n // c
        if num_chunks <= 0:
            raise ValueError(f"waveform of {n} samples shorter than chunk {c}")
        if s == SelectionStrategy.random_contiguous:
            if rng is None:
                raise ValueError("random_contiguous strategy requires an rng")
            k = int(rng.integers(0, num_chunks))
            return [wav[..., k * c : (k + 1) * c]]
        if s == SelectionStrategy.contiguous:
            return [wav[..., k * c : (k + 1) * c] for k in range(num_chunks)]
        raise ValueError(f"unknown strategy {s}")
