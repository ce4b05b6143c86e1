"""Character tokenizer of the speech (CTC) task: the port's copy of
``w2v2_speaker_tpu/data/tokenizer.py::CharTokenizer`` (:41).

The vocabulary maps ``<pad>`` to 0, which doubles as the CTC blank, and
writes a space as the word delimiter ``|``. ``build`` derives it from
transcripts (``<pad>``, ``<unk>``, ``|``, then the sorted characters);
``wav2vec2_base_960h`` is the fixed 32-token letter vocabulary of
facebook/wav2vec2-base-960h in checkpoint order. ``decode`` is CTC's
greedy rule: repeats collapsed, blanks and the ``<s>`` / ``</s>`` tokens
dropped, runs of spaces squeezed.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Sequence

import numpy as np

__all__ = ["CharTokenizer"]

BLANK = "<pad>"  # the CTC blank, index 0
UNK = "<unk>"
WORD_DELIM = "|"

_W2V2_960H_VOCAB = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5, "T": 6,
    "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12, "R": 13, "D": 14,
    "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20, "G": 21,
    "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28,
    "J": 29, "Q": 30, "Z": 31,
}


class CharTokenizer:
    def __init__(self, vocab: Dict[str, int]):
        if vocab.get(BLANK) != 0:
            raise ValueError(f"vocab must map {BLANK!r} (CTC blank) to 0")
        self.vocab = dict(vocab)
        self.inverse = {i: c for c, i in vocab.items()}

    @classmethod
    def build(cls, transcriptions: Iterable[str]) -> "CharTokenizer":
        chars = set()
        for text in transcriptions:
            chars.update(text.upper().replace(" ", WORD_DELIM))
        chars.discard(WORD_DELIM)
        vocab = {BLANK: 0, UNK: 1, WORD_DELIM: 2}
        for c in sorted(chars):
            vocab[c] = len(vocab)
        return cls(vocab)

    @classmethod
    def wav2vec2_base_960h(cls) -> "CharTokenizer":
        return cls(dict(_W2V2_960H_VOCAB))

    @classmethod
    def load(cls, path: pathlib.Path | str) -> "CharTokenizer":
        return cls(json.loads(pathlib.Path(path).read_text()))

    def save(self, path: pathlib.Path | str) -> None:
        pathlib.Path(path).write_text(json.dumps(self.vocab, indent=2))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def blank_id(self) -> int:
        return 0

    def encode(self, text: str) -> np.ndarray:
        """int32 ids of ``text`` upper-cased, ``<unk>`` for characters
        outside the vocabulary."""
        unk = self.vocab[UNK]
        return np.asarray([self.vocab.get(c, unk) for c in text.upper().replace(" ", WORD_DELIM)],
                          dtype=np.int32)

    def decode(self, ids: Sequence[int], ctc: bool = True) -> str:
        out: List[str] = []
        prev = None
        for i in ids:
            i = int(i)
            if ctc and i == prev:
                continue
            prev = i
            if i == self.blank_id:
                continue
            tok = self.inverse.get(i, "")
            if tok not in ("<s>", "</s>"):
                out.append(tok)
        return " ".join("".join(out).replace(WORD_DELIM, " ").split())

    def decode_batch(self, logits: np.ndarray, lengths: np.ndarray) -> List[str]:
        """Greedy CTC decode of [B, T, V] logits, row b up to ``lengths[b]``."""
        ids = np.argmax(logits, axis=-1)
        return [self.decode(ids[b, : int(lengths[b])]) for b in range(ids.shape[0])]
