"""Random fixed-size speaker batches: the port's copy of
``w2v2_speaker_tpu/data/batching.py::RandomBatchProcessor`` (:43).

Samples fill a queue of ``max_queue_size``; each batch draws
``max_batch_size`` of them at random from a seeded numpy generator, in the
JAX package's order of draws. The triplet, paired and token-budget batch
processors (:80-387) are not ported yet: ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List

import numpy as np

from .samples import SpeakerSample

__all__ = ["RandomBatchProcessor"]


class RandomBatchProcessor:
    def __init__(self, max_batch_size: int, max_queue_size: int,
                 collate_fn: Callable[[List[SpeakerSample]], Dict], seed: int = 0):
        if max_batch_size <= 0:
            raise ValueError("max_batch_size needs to be a positive integer")
        if max_queue_size <= 0 or max_queue_size < max_batch_size:
            raise ValueError(f"queue size must be >= max_batch_size={max_batch_size}")
        self.max_batch_size = max_batch_size
        self.max_queue_size = max_queue_size
        self.collate_fn = collate_fn
        self.rng = np.random.default_rng(seed)

    def __call__(self, samples: Iterable[SpeakerSample]) -> Iterator[Dict]:
        queue: List[SpeakerSample] = []
        for s in samples:
            queue.append(s)
            if len(queue) >= self.max_queue_size:
                yield self._draw(queue)
        while queue:
            yield self._draw(queue)

    def _draw(self, queue: List[SpeakerSample]) -> Dict:
        batch = []
        while len(batch) < self.max_batch_size and queue:
            batch.append(queue.pop(int(self.rng.integers(len(queue)))))
        return self.collate_fn(batch)
