"""Thread-safe random draws for the data pipeline: the port's copy of
``w2v2_speaker_tpu/data/augment.py::LockedGenerator`` (:200).

The waveform augmentations of that module (``Augmenter`` :414 and its
effect chain) are not ported yet (ROADMAP.md Queue 1 item 2); every
wav2vec2 recipe runs with ``augment.enabled`` false, and
``runtime.experiment.build_augmenter`` raises for any other setting.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["LockedGenerator"]


class LockedGenerator:
    """A ``numpy.random.Generator`` whose every draw holds a lock, so the
    pipeline's worker threads can share one stream."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        method = getattr(self._rng, name)

        def locked(*args, **kwargs):
            with self._lock:
                return method(*args, **kwargs)

        return locked
