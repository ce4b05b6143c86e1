"""LibriSpeech data module of the speech (CTC) task: the port's copy of
``w2v2_speaker_tpu/data/librispeech.py``.

- ``write_librispeech_shards`` (:72): the ``<spk>/<chapter>/<spk>-<chapter>-<utt>``
  WAV or FLAC files that have a line in their chapter's ``.trans.txt``
  (``_discover_transcribed_wavs`` :46), sorted by length before sharding,
  and a ``meta.json`` with the characters of the transcripts and the
  speakers of the keys;
- ``LibriSpeechDataModule`` (:168): ``prepare_data`` shards every split
  once and writes ``vocab.json`` (a ``CharTokenizer`` over the characters
  of all splits); ``tokenizer`` (that vocabulary, or the fixed
  ``wav2vec2_base_960h`` one); the train speakers' class map; balanced
  speaker trials over an eval split; the vocabulary check; training
  batches of a token budget (``DynamicTokenBudgetBatcher``, shard order
  and draws seeded ``seed + epoch * 9973``) and eval batches of a fixed
  count, in shard order, each behind a prefetch thread.

The layout of the shards is the speaker corpus's (``data/shards.py``), so
each package reads the other's. A ``debug_capture``
(``runtime.debug.PipelineDebugCapture``) records, for the first samples of
the first training epoch, the decoded audio (``original``), the
transcript (``transcription``) and the token ids (``tokens``), as the JAX
package's (:299-312). Left out
as options no caller of the port sets: the split of the training shards
across hosts (``host_id``/``num_hosts``; one card reads them all),
gzip-compressed shards and ``normalize_input`` (which the reference
reads nowhere).
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from .batching import DynamicTokenBudgetBatcher
from .datamodule import Prefetcher
from .io import load_raw_audio
from .samples import SpeechSample, collate_speech_batch
from .shards import ShardReader, ShardWriter
from .tokenizer import CharTokenizer
from .trials import EvaluationPair, generate_validation_pairs

__all__ = ["LibriSpeechConfig", "LibriSpeechDataModule", "write_librispeech_shards"]


def _discover_transcribed_wavs(root: pathlib.Path) -> List[Dict]:
    entries = []
    for trans in sorted(root.rglob("*.trans.txt")):
        lookup: Dict[str, str] = {}
        for line in trans.read_text().splitlines():
            if line.strip():
                utt_id, text = line.split(" ", 1)
                lookup[utt_id] = text.strip()
        audio = sorted(trans.parent.glob("*.wav")) + sorted(trans.parent.glob("*.flac"))
        entries += [{"path": a, "key": a.stem, "transcription": lookup[a.stem]}
                    for a in audio if a.stem in lookup]
    return entries


def write_librispeech_shards(root: pathlib.Path | str, out_dir: pathlib.Path | str,
                             samples_per_shard: int = 64) -> Dict:
    """Shards ``speech-NNNNNN.tar`` of ``samples_per_shard`` samples
    in order of length under ``out_dir``; returns the ``meta.json`` it
    writes."""
    root, out_dir = pathlib.Path(root), pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = _discover_transcribed_wavs(root)
    if not entries:
        raise ValueError(f"no transcribed wavs under {root}")
    loaded, charset = [], set()
    for e in entries:
        charset.update(e["transcription"].upper().replace(" ", "|"))
        loaded.append((e["key"], load_raw_audio(e["path"]), e["transcription"]))
    loaded.sort(key=lambda x: x[1].shape[-1])

    shards = 0
    for i in range(0, len(loaded), samples_per_shard):
        with ShardWriter(out_dir / f"speech-{shards:06d}.tar") as w:
            for key, wav, text in loaded[i : i + samples_per_shard]:
                w.write(key, wav, {"transcription": text, "num_frames": int(wav.shape[-1]),
                                   "sampling_rate": 16000})
        shards += 1
    meta = {
        "num_shards": shards,
        "num_samples": len(loaded),
        "characters": sorted(charset - {"|"}),
        "speakers": sorted({k.split("-")[0] for k, _, _ in loaded}),
    }
    (out_dir / "meta.json").write_text(json.dumps(meta, indent=2))
    return meta


@dataclass
class LibriSpeechConfig:
    split_dirs: Dict[str, pathlib.Path] = field(default_factory=dict)  # split -> raw directory
    shards_dir: pathlib.Path = pathlib.Path("shards")
    samples_per_shard: int = 64
    train_max_num_samples: int = 3_200_000  # token budget: rows x the longest row
    max_queue_size: int = 128
    max_batch_size: Optional[int] = None
    pad_to_multiple: int = 1600
    tokenizer_name: str = "corpus_char"  # or "wav2vec2_base_960h"
    with_speaker_labels: bool = False  # attach each utterance's speaker class
    seed: int = 0
    debug_capture: Optional[Any] = None


class LibriSpeechDataModule:
    TRAIN = "train"

    def __init__(self, cfg: LibriSpeechConfig):
        self.cfg = cfg
        self.cfg.shards_dir = pathlib.Path(cfg.shards_dir)
        self._tokenizer: Optional[CharTokenizer] = None
        self._speaker_map: Optional[Dict[str, int]] = None

    def prepare_data(self) -> None:
        """Shard every split and write ``vocab.json`` and ``prepared.json``;
        nothing when ``prepared.json`` exists."""
        cfg = self.cfg
        marker = cfg.shards_dir / "prepared.json"
        if marker.exists():
            return
        cfg.shards_dir.mkdir(parents=True, exist_ok=True)
        all_chars: set = set()
        info = {}
        for split, raw_dir in cfg.split_dirs.items():
            meta = write_librispeech_shards(raw_dir, cfg.shards_dir / split,
                                            samples_per_shard=cfg.samples_per_shard)
            info[split] = meta["num_samples"]
            all_chars.update(meta["characters"])
        CharTokenizer.build(["".join(sorted(all_chars)) + " "]).save(cfg.shards_dir / "vocab.json")
        marker.write_text(json.dumps(info, indent=2))

    @property
    def tokenizer(self) -> CharTokenizer:
        if self._tokenizer is None:
            self._tokenizer = (CharTokenizer.wav2vec2_base_960h()
                               if self.cfg.tokenizer_name == "wav2vec2_base_960h"
                               else CharTokenizer.load(self.cfg.shards_dir / "vocab.json"))
        return self._tokenizer

    @property
    def speaker_id_to_idx(self) -> Dict[str, int]:
        """Train speaker -> class index, in sorted order: from the train
        split's ``meta.json``, else (shards written before the field) from
        a scan of the shard keys kept in ``speakers.json``."""
        if self._speaker_map is not None:
            return self._speaker_map
        d = self.cfg.shards_dir / self.TRAIN
        speakers = None
        if (d / "meta.json").exists():
            speakers = json.loads((d / "meta.json").read_text()).get("speakers")
        if speakers is None:
            cache = d / "speakers.json"
            if cache.exists():
                speakers = json.loads(cache.read_text())
            else:
                speakers = sorted({k.split("-")[0] for k in ShardReader(ShardReader.discover(d)).iter_keys()})
                cache.write_text(json.dumps(speakers))
        self._speaker_map = {s: i for i, s in enumerate(speakers)}
        return self._speaker_map

    @property
    def num_speakers(self) -> int:
        return len(self.speaker_id_to_idx)

    def val_evaluation_pairs(self, split: str = "val_clean", num_pairs: int = 200) -> List[EvaluationPair]:
        """Balanced same/different-speaker trials over ``split``'s keys
        (no audio read)."""
        per_speaker: Dict[str, List[str]] = {}
        for key in ShardReader(ShardReader.discover(self.cfg.shards_dir / split)).iter_keys():
            per_speaker.setdefault(key.split("-")[0], []).append(key)
        return generate_validation_pairs(per_speaker, num_pairs, seed=self.cfg.seed)

    def vocabulary_consistency_check(self) -> None:
        """Raises when a transcript holds a character outside the
        tokenizer's vocabulary."""
        tok = self.tokenizer
        for split in self.cfg.split_dirs:
            for s in self._samples(split, capture=False):
                if (tok.encode(s.transcription) == tok.vocab["<unk>"]).any():
                    raise ValueError(
                        f"transcript of {s.key} contains characters outside the tokenizer vocabulary")

    def _samples(self, split: str, epoch: int = 0, capture: bool = True) -> Iterator[SpeechSample]:
        cfg = self.cfg
        reader = ShardReader(ShardReader.discover(cfg.shards_dir / split),
                             shuffle_shards=split == self.TRAIN, seed=cfg.seed + epoch * 9973)
        tok = self.tokenizer
        spk_map = self.speaker_id_to_idx if cfg.with_speaker_labels else None
        # the first training epoch only: eval reads and later epochs would
        # add stages to keys already recorded
        cap = cfg.debug_capture if capture and split == self.TRAIN and epoch == 0 else None
        for s in reader:
            text = s.meta["transcription"]
            tokens = tok.encode(text)
            if cap is not None and cap.wants(s.key):
                cap.record(s.key, "original", s.wav)
                cap.record_text(s.key, "transcription", text)
                cap.record(s.key, "tokens", tokens, render_wav=False)
            yield SpeechSample(
                key=s.key, wav=s.wav.astype(np.float32), transcription=text, tokens=tokens,
                speaker_idx=None if spk_map is None else spk_map.get(s.key.split("-")[0], -1),
            )

    def train_batches(self, prefetch_depth: int = 4, epoch: int = 0) -> Iterable[Dict]:
        cfg = self.cfg
        proc = DynamicTokenBudgetBatcher(
            max_samples_in_batch=cfg.train_max_num_samples, max_queue_size=cfg.max_queue_size,
            collate_fn=lambda samples: collate_speech_batch(samples, pad_to_multiple=cfg.pad_to_multiple),
            max_batch_size=cfg.max_batch_size, seed=cfg.seed + epoch * 9973,
        )
        return Prefetcher(lambda: proc(self._samples(self.TRAIN, epoch=epoch)), depth=prefetch_depth)

    def eval_batches(self, split: str, batch_size: int = 8) -> Iterable[Dict]:
        """``split``'s samples in shard order (shards are length-sorted),
        ``batch_size`` to a batch, the last one partial."""
        pad = self.cfg.pad_to_multiple

        def gen():
            batch: List[SpeechSample] = []
            for s in self._samples(split):
                batch.append(s)
                if len(batch) == batch_size:
                    yield collate_speech_batch(batch, pad_to_multiple=pad)
                    batch = []
            if batch:
                yield collate_speech_batch(batch, pad_to_multiple=pad)

        return Prefetcher(gen)
