"""Trial (evaluation pair) lists for speaker verification (copy of
``w2v2_speaker_tpu/data/trials.py``): ``EvaluationPair``,
``load_evaluation_pairs`` (:46; lines ``<gt> <spk>/<yt>/<utt>.wav
<spk>/<yt>/<utt>.wav``, ids without ``.wav``, the ground truth checked
against the speaker-id path components), ``save_evaluation_pairs`` and the
balanced, seeded ``generate_validation_pairs`` (:70).
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "EvaluationPair",
    "load_evaluation_pairs",
    "save_evaluation_pairs",
    "generate_validation_pairs",
]


@dataclass(frozen=True)
class EvaluationPair:
    same_speaker: bool
    sample1_id: str
    sample2_id: str


def _iter_pair_lines(path: pathlib.Path) -> Iterable[Tuple[bool, str, str]]:
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line.count(" ") < 2:
                continue
            gt, p1, p2 = line.split(" ")
            yield bool(int(gt)), p1, p2


def load_evaluation_pairs(path: pathlib.Path | str) -> List[EvaluationPair]:
    """Parse a VoxCeleb-style trial file, verifying gt/speaker-id consistency."""
    pairs = []
    for gt, p1, p2 in _iter_pair_lines(pathlib.Path(path)):
        utt1 = p1.split(".wav")[0]
        utt2 = p2.split(".wav")[0]
        spk1 = p1.split("/")[0]
        spk2 = p2.split("/")[0]
        if (spk1 == spk2) != gt:
            raise ValueError(f"read gt={gt} for line `{p1} {p2}`")
        pairs.append(EvaluationPair(gt, utt1, utt2))
    return pairs


def save_evaluation_pairs(
    pairs: Sequence[EvaluationPair], path: pathlib.Path | str
) -> None:
    with open(path, "w") as f:
        for p in pairs:
            f.write(
                f"{int(p.same_speaker)} {p.sample1_id}.wav {p.sample2_id}.wav\n"
            )


def generate_validation_pairs(
    sample_ids_per_speaker: Dict[str, List[str]],
    num_pairs: int,
    seed: int = 0,
) -> List[EvaluationPair]:
    """Generate a balanced pos/neg validation trial list.

    Positive pairs: cycle through speakers (sorted order for determinism),
    picking an unseen same-speaker pair each visit. Negative pairs: pick two
    distinct speakers weighted toward those least used so far, then an unseen
    cross-speaker pair. Output interleaves negative/positive like the
    reference writer (`voxceleb.py:752-775`).
    """
    rng = np.random.default_rng(seed)
    n_pos = num_pairs // 2
    n_neg = num_pairs - n_pos

    speakers = sorted(sample_ids_per_speaker)
    if len(speakers) < 2:
        raise ValueError("need at least two speakers for negative pairs")

    seen: set = set()

    def unseen(a: str, b: str) -> bool:
        return (a, b) not in seen and (b, a) not in seen

    # positive pairs: round-robin over speakers
    positive: List[Tuple[str, str]] = []
    queue = list(speakers)
    while len(positive) < n_pos:
        if not queue:
            raise ValueError(f"cannot generate {n_pos} positive pairs")
        spk = queue.pop()
        queue.insert(0, spk)
        samples = list(sample_ids_per_speaker[spk])
        rng.shuffle(samples)
        added = False
        for i in range(len(samples)):
            for j in range(i + 1, len(samples)):
                a, b = samples[i], samples[j]
                if a != b and unseen(a, b):
                    positive.append((a, b))
                    seen.add((a, b))
                    added = True
                    break
            if added:
                break
        if not added:
            queue.remove(spk)

    # negative pairs: least-used speakers first
    negative: List[Tuple[str, str]] = []
    use_count = {s: 0 for s in speakers}
    fails = 0
    while len(negative) < n_neg:
        if fails > 100:
            raise ValueError(f"cannot generate {n_neg} negative pairs")
        names = sorted(use_count)
        total = 2 * len(negative)
        weights = np.array([total - use_count[s] + 1 for s in names], float)
        spk1 = names[int(rng.choice(len(names), p=weights / weights.sum()))]
        idx = names.index(spk1)
        names.pop(idx)
        weights = np.delete(weights, idx)
        spk2 = names[int(rng.choice(len(names), p=weights / weights.sum()))]

        s1 = list(sample_ids_per_speaker[spk1])
        s2 = list(sample_ids_per_speaker[spk2])
        rng.shuffle(s1)
        rng.shuffle(s2)
        added = False
        for a in s1:
            for b in s2:
                if unseen(a, b):
                    negative.append((a, b))
                    seen.add((a, b))
                    use_count[spk1] += 1
                    use_count[spk2] += 1
                    added = True
                    break
            if added:
                break
        if not added:
            fails += 1

    # interleave: neg first (count starts at 1 == odd -> negative)
    out: List[EvaluationPair] = []
    pos, neg = list(positive), list(negative)
    toggle = 0
    while pos or neg:
        toggle += 1
        if toggle % 2 == 0:
            if pos:
                a, b = pos.pop()
                out.append(EvaluationPair(True, a, b))
        else:
            if neg:
                a, b = neg.pop()
                out.append(EvaluationPair(False, a, b))
    return out
