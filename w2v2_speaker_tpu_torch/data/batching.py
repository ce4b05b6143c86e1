"""Batch processors: the port's copies of
``w2v2_speaker_tpu/data/batching.py::RandomBatchProcessor`` (:43),
``TripletBatchProcessor`` (:78), ``PairedBatchProcessor`` (:154) and
``DynamicTokenBudgetBatcher`` (:338).

``RandomBatchProcessor``: samples fill a queue of ``max_queue_size``; each
batch draws ``max_batch_size`` of them at random. ``TripletBatchProcessor``
(the triplet recipes'): samples queue by speaker until a full batch of
same-speaker (anchor, positive) couples over at least two speakers can be
drawn, so every anchor has an in-batch positive and a negative and the
batch shape stays fixed; it raises when the queue grows to twice its limit
without such a batch, and drops the samples left at the end (the JAX
package's ``ensure_all_samples_seen``, which yields them as a last batch,
has no caller in either package). ``PairedBatchProcessor``:
in ``generate`` mode it queues runs of ``sequential_same_speaker_samples``
(k) samples and builds batches of positive and negative pairs at
``pos_neg_training_batch_ratio`` from speakers drawn with weights 2^count;
in ``reproduce`` mode it yields the exact pairs of a trial list, the last
partial batch kept. ``DynamicTokenBudgetBatcher`` (the speech task's)
sorts its queue by length, grows a batch around a drawn sample while rows
x the longest row stay within the token budget, and skips a sample longer
than the budget. Every draw comes from the processor's own
``np.random.default_rng(seed)``, in the JAX package's order, so both
packages yield the same batches at one seed.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from .samples import PairedSample, SpeakerSample, SpeechSample
from .trials import EvaluationPair

__all__ = ["DynamicTokenBudgetBatcher", "PairedBatchProcessor", "RandomBatchProcessor", "TripletBatchProcessor"]


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


class TripletBatchProcessor:
    def __init__(self, max_batch_size: int, max_queue_size: int,
                 collate_fn: Callable[[List[SpeakerSample]], Dict], seed: int = 0):
        if max_batch_size % 2 == 1:
            raise ValueError("batch size needs to be even to allow triplets")
        self.max_batch_size = max_batch_size
        self.max_queue_size = max_queue_size
        self.collate_fn = collate_fn
        self.rng = np.random.default_rng(seed)

    def __call__(self, samples: Iterable[SpeakerSample]) -> Iterator[Dict]:
        by_speaker: Dict[int, List[SpeakerSample]] = defaultdict(list)
        size = 0
        seen_keys = set()

        def can_fill():
            """A full batch of (anchor, positive) couples over >= 2 speakers
            can be drawn."""
            valid = [k for k, v in by_speaker.items() if len(v) >= 2]
            pairs = sum(len(v) // 2 for v in by_speaker.values())
            return len(valid) >= 2 and pairs >= self.max_batch_size // 2

        for s in samples:
            if s.key in seen_keys:
                raise ValueError(f"duplicate sample {s.key}")
            seen_keys.add(s.key)
            by_speaker[s.ground_truth].append(s)
            size += 1
            if size >= self.max_queue_size and can_fill():
                yield self._draw(by_speaker)
                size = sum(len(v) for v in by_speaker.values())
            if size >= self.max_queue_size * 2:
                raise ValueError("queue exceeded limit while unable to ensure triplets")
        while can_fill():
            yield self._draw(by_speaker)
            size = sum(len(v) for v in by_speaker.values())
        leftovers = sum(len(v) for v in by_speaker.values())
        if leftovers:
            print(f"discarding {leftovers} samples due to no triplet")

    def _draw(self, by_speaker) -> Dict:
        """``max_batch_size`` samples popped as same-speaker couples of
        speakers drawn without replacement, round after round while the
        batch is short (a speaker may give several couples)."""
        batch = []
        while len(batch) < self.max_batch_size:
            valid = [k for k, v in by_speaker.items() if len(v) >= 2]
            take = min(len(valid), (self.max_batch_size - len(batch)) // 2)
            chosen = self.rng.choice(np.asarray(valid), size=take, replace=False)
            for k in chosen.tolist():
                lst = by_speaker[k]
                for _ in range(2):
                    batch.append(lst.pop(int(self.rng.integers(len(lst)))))
                if not lst:
                    del by_speaker[k]
        return self.collate_fn(batch)


class PairedBatchProcessor:
    def __init__(
        self,
        batch_size: int,
        max_queue_size: int,
        mode: str,  # 'generate' | 'reproduce'
        sequential_same_speaker_samples: int,
        collate_fn: Callable[[List[PairedSample]], Dict],
        pos_neg_training_batch_ratio: Optional[float] = None,
        pairs: Optional[List[EvaluationPair]] = None,
        seed: int = 0,
    ):
        if mode not in ("generate", "reproduce"):
            raise ValueError(f"mode={mode} should be 'generate'|'reproduce'")
        if batch_size > max_queue_size:
            raise ValueError("batch_size must be <= max_queue_size")
        if mode == "generate":
            if pos_neg_training_batch_ratio is None:
                raise ValueError("generate mode requires pos_neg_training_batch_ratio")
            if batch_size % sequential_same_speaker_samples != 0:
                raise ValueError("batch_size must be divisible by sequential_same_speaker_samples")
        if mode == "reproduce" and pairs is None:
            raise ValueError("reproduce mode requires pairs")
        self.batch_size = batch_size
        self.max_queue_size = max_queue_size
        self.mode = mode
        self.k = sequential_same_speaker_samples
        self.collate_fn = collate_fn
        self.ratio = pos_neg_training_batch_ratio
        self.pairs = pairs
        self.rng = np.random.default_rng(seed)

    def __call__(self, samples: Iterable[SpeakerSample]) -> Iterator[Dict]:
        if self.mode == "generate":
            yield from self._generate(samples)
        else:
            yield from self._reproduce(samples)

    def _generate(self, samples) -> Iterator[Dict]:
        """A batch each time the queue holds ``max_queue_size`` (rounded
        down to whole batches) after a run of k; then batches until the
        queue runs short."""
        num_pos = round(self.ratio * self.batch_size)
        num_neg = self.batch_size - num_pos
        queue: List[SpeakerSample] = []
        max_queue = max(self.batch_size, (self.max_queue_size // self.batch_size) * self.batch_size)
        run_left = self.k
        for s in samples:
            queue.append(s)
            run_left -= 1
            if run_left > 0:
                continue
            run_left = self.k
            if len(queue) >= max_queue:
                batch = self._paired_batch(queue, num_pos, num_neg)
                if batch is not None:
                    yield self.collate_fn(batch)
        while queue:
            batch = self._paired_batch(queue, num_pos, num_neg)
            if batch is None:
                return
            yield self.collate_fn(batch)

    def _paired_batch(self, queue, num_pos, num_neg):
        """``batch_size / k`` speakers drawn with weights 2^count, k samples
        each; ``num_pos`` same-speaker and ``num_neg`` cross-speaker pairs
        among them, no pair twice (100 failed draws raise); the drawn
        samples leave the queue; the pairs shuffled. None (and the queue
        emptied) when the queue holds less than a batch."""
        if len(queue) < self.batch_size:
            queue.clear()
            return None
        speaker_map: Dict[int, List[SpeakerSample]] = defaultdict(list)
        for s in queue:
            speaker_map[s.ground_truth].append(s)

        n_speakers = self.batch_size // self.k
        ids = list(speaker_map)
        weights = np.asarray([2.0 ** len(speaker_map[i]) for i in ids], dtype=np.float64)
        chosen = []
        while len(chosen) < n_speakers and ids:
            j = int(self.rng.choice(len(ids), p=weights / weights.sum()))
            chosen.append(ids.pop(j))
            weights = np.delete(weights, j)

        batch_map: Dict[int, List[SpeakerSample]] = defaultdict(list)
        for spk in chosen:
            lst = speaker_map[spk]
            for _ in range(min(self.k, len(lst))):
                batch_map[spk].append(lst.pop(int(self.rng.integers(len(lst)))))

        def rand_choice(lst):
            return lst[int(self.rng.integers(len(lst)))]

        pos, fails, seen = [], 0, set()
        while len(pos) < num_pos:
            if fails >= 100:
                raise ValueError("too many fails generating positive pairs")
            lst = batch_map[rand_choice(chosen)]
            if len(lst) < 2:
                fails += 1
                continue
            i, j = self.rng.choice(len(lst), size=2, replace=False)
            s1, s2 = lst[int(i)], lst[int(j)]
            if (s1.key, s2.key) in seen:
                fails += 1
                continue
            seen.add((s1.key, s2.key))
            pos.append(PairedSample(s1.key, s1.wav, s2.key, s2.wav, ground_truth=1))
        neg, fails = [], 0
        while len(neg) < num_neg:
            if fails >= 100:
                raise ValueError("too many fails generating negative pairs")
            if len(chosen) < 2:
                raise ValueError("need >= 2 speakers for negative pairs")
            a, b = self.rng.choice(len(chosen), size=2, replace=False)
            l1, l2 = batch_map[chosen[int(a)]], batch_map[chosen[int(b)]]
            if not l1 or not l2:
                fails += 1
                continue
            s1, s2 = rand_choice(l1), rand_choice(l2)
            if (s1.key, s2.key) in seen:
                fails += 1
                continue
            seen.add((s1.key, s2.key))
            neg.append(PairedSample(s1.key, s1.wav, s2.key, s2.wav, ground_truth=0))

        for lst in batch_map.values():
            for s in lst:
                queue.remove(s)
        out = pos + neg
        self.rng.shuffle(out)
        return out

    def _reproduce(self, samples) -> Iterator[Dict]:
        sample_dict = {s.key: s for s in samples}
        if not sample_dict:
            return
        batch: List[PairedSample] = []
        for p in self.pairs:
            s1, s2 = sample_dict[p.sample1_id], sample_dict[p.sample2_id]
            batch.append(PairedSample(s1.key, s1.wav, s2.key, s2.wav, ground_truth=1 if p.same_speaker else 0))
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch:
            yield self.collate_fn(batch)


class DynamicTokenBudgetBatcher:
    def __init__(self, max_samples_in_batch: int, max_queue_size: int,
                 collate_fn: Callable[[List[SpeechSample]], Dict],
                 max_batch_size: Optional[int] = None, seed: int = 0):
        self.budget = max_samples_in_batch  # rows x the longest row's samples
        self.max_queue_size = max_queue_size
        self.collate_fn = collate_fn
        self.max_batch_size = max_batch_size
        self.rng = np.random.default_rng(seed)

    def __call__(self, samples: Iterable[SpeechSample]) -> Iterator[Dict]:
        queue: List[SpeechSample] = []
        for s in samples:
            if s.wav.shape[-1] > self.budget:
                print(f"skipping over-budget sample {s.key}")
                continue
            queue.append(s)
            if len(queue) >= self.max_queue_size:
                yield self._draw(queue)
        while queue:
            yield self._draw(queue)

    def _draw(self, queue: List[SpeechSample]) -> Dict:
        """A drawn sample of the length-sorted queue, grown to the right
        while the budget allows, else to the left, up to
        ``max_batch_size`` rows; the batch leaves the queue."""
        queue.sort(key=lambda s: s.wav.shape[-1])
        lo = hi = int(self.rng.integers(len(queue)))

        def cost(l, h):  # sorted: row h is the longest
            return (h - l + 1) * queue[h].wav.shape[-1]

        while not (self.max_batch_size and hi - lo + 1 >= self.max_batch_size):
            if hi + 1 < len(queue) and cost(lo, hi + 1) <= self.budget:
                hi += 1
            elif lo > 0 and cost(lo - 1, hi) <= self.budget:
                lo -= 1
            else:
                break
        batch = [queue.pop(i) for i in range(hi, lo - 1, -1)][::-1]
        return self.collate_fn(batch)
