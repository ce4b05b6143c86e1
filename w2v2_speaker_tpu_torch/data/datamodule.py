"""VoxCeleb data module: one-time preparation, then streaming train, val and
test loaders. The port's copy of ``w2v2_speaker_tpu/data/datamodule.py``
(``VoxCelebConfig`` :58, ``Prefetcher`` :122, ``ParallelMap`` :182,
``VoxCelebDataModule`` :219), numpy only, drawing every random number as
the JAX package draws it, so both packages give the same batches at one
seed:

- ``prepare_data`` (:257): discover ``spk/yt/utt.wav`` files (extracting
  raw archives first where a root holds none), split the test speakers out
  by the trial file, split train/val ``equal`` (whole YouTube sessions per
  speaker by ratio) or ``different`` (held-out speakers), write tar shards
  per split, check that the splits are disjoint, and write balanced
  validation pairs and ``prepared.json``;
- ``train_batches`` (:557): shards -> the ``augmenter``'s samples ->
  chunks -> normalisation -> ``RandomBatchProcessor`` -> a prefetch thread
  of numpy batches (the per-sample work in ``ParallelMap`` threads with
  ``num_pipeline_workers`` > 1); ``val_batches`` (:572): first-3 s crops
  in order, never augmented; ``test_samples`` (:589): full normalised
  utterances.

A ``debug_capture`` (``runtime.debug.PipelineDebugCapture``, installed by
the run for ``trainer.dump_first_batch``) records each sample's stages in
the JAX order (:497-549): ``original``, the augmenter's effects,
``chunk<i>``, ``normalize<i>``.
"""

from __future__ import annotations

import json
import pathlib
import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from .augment import Augmenter, LockedGenerator
from .batching import RandomBatchProcessor
from .chunks import ChunkSelector
from .io import load_raw_audio
from .normalize import normalize_waveform
from .samples import SpeakerSample, collate_speaker_batch
from .shards import ShardReader, read_meta, write_speaker_shards
from .trials import EvaluationPair, generate_validation_pairs, load_evaluation_pairs, save_evaluation_pairs

__all__ = ["VoxCelebConfig", "VoxCelebDataModule", "Prefetcher", "ParallelMap"]


@dataclass
class VoxCelebConfig:
    # single-corpus root with spk/yt/utt.wav files; alternatively compose
    # multiple corpora below (then data_dir may be None)
    data_dir: Optional[pathlib.Path] = None
    shards_dir: pathlib.Path = pathlib.Path("shards")  # output for shard sets
    test_trial_path: Optional[pathlib.Path] = None  # veri_test2.txt style
    # -------- multi-corpus composition (the reference's headline protocol:
    # train on VoxCeleb2-dev, test on all of VoxCeleb1 via the E/H trial
    # lists — voxceleb.py:1442-1520 + config/data/module/
    # voxceleb2_test_{everyone,hard}.yaml:7-24). Each root is a spk/yt/utt
    # tree (or an archive dir, auto-extracted). `use_*` toggles inclusion;
    # dev corpora feed train/val unless their speakers appear in the trial
    # file; test corpora only ever contribute trial-file speakers;
    # `all_voxceleb1_is_test_set` demotes voxceleb1-dev to a test-only
    # source (its non-trial speakers are dropped, matching the reference).
    voxceleb1_dev_dir: Optional[pathlib.Path] = None
    voxceleb1_test_dir: Optional[pathlib.Path] = None
    voxceleb2_dev_dir: Optional[pathlib.Path] = None
    voxceleb2_test_dir: Optional[pathlib.Path] = None
    use_voxceleb1_dev: bool = True
    use_voxceleb1_test: bool = True
    use_voxceleb2_dev: bool = True
    use_voxceleb2_test: bool = False
    all_voxceleb1_is_test_set: bool = False
    # which splits to shard (reference has_train/has_val/has_test,
    # voxceleb2_test_hard.yaml:13-16): the split logic always runs, but
    # disabled splits are not written (e.g. eval-only shard sets)
    has_train: bool = True
    has_val: bool = True
    has_test: bool = True
    train_val_split_mode: str = "equal"  # 'equal' | 'different'
    train_val_ratio: float = 0.97  # fraction of data (or speakers) for train
    # 'different' mode: hold out exactly this many val speakers (reference
    # num_val_speakers, voxceleb.py:1527-1579); <=0 falls back to the ratio
    num_val_speakers: int = 0
    eer_validation_pairs: int = 1000
    samples_per_shard: int = 100
    sequential_same_speaker_samples: int = 1
    min_unique_speakers_per_shard: int = 1
    use_gzip_compression: bool = False
    shuffle_shards: bool = True
    queue_size: int = 256
    batch_size: int = 64
    chunk_length_sec: Optional[float] = 3.0  # None = full sequences
    chunk_strategy: str = "random"
    normalize_input: bool = True
    augmenter: Optional[Augmenter] = None  # train split only
    limit_samples: Optional[int] = None  # deterministic small-data runs
    num_pipeline_workers: int = 1  # >1: thread-pool per-sample DSP (order
    # preserved; RNG draws serialize behind locks, so exact streams differ
    # from the single-worker run — same caveat as DataLoader workers)
    seed: int = 123
    host_id: int = 0
    num_hosts: int = 1
    # installed by the run, not read from YAML: a
    # runtime.debug.PipelineDebugCapture told each stage of the first samples
    debug_capture: Optional[Any] = None


class Prefetcher:
    """Background-thread prefetch over a batch generator."""

    def __init__(self, gen_fn: Callable[[], Iterator[Dict]], depth: int = 4):
        self.gen_fn = gen_fn
        self.depth = depth

    def __iter__(self):
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.depth)
        sentinel = object()
        error: List[BaseException] = []
        stop = threading.Event()

        def worker():
            gen = self.gen_fn()
            try:
                for item in gen:
                    # bounded put so an abandoned consumer (`break` out of
                    # the loop, `next(iter(...))`) can't leave this thread
                    # blocked on a full queue forever — validation loops
                    # with limit_val break out every val_check_interval
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue_mod.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                # close shard readers/file handles deterministically
                close = getattr(gen, "close", None)
                if close is not None:
                    close()
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            # consumer abandoned (GeneratorExit) or finished: release the
            # worker and wait so its pipeline state is fully torn down
            stop.set()
            t.join(timeout=5.0)


class ParallelMap:
    """Ordered thread-pool map over a sample stream.

    numpy releases the GIL in the per-sample work, so a thread pool spreads
    it over the host's cores, in place of DataLoader worker processes.
    Order is preserved, so a seeded pipeline is reproducible for a fixed
    worker count.
    """

    def __init__(self, fn, workers: int = 4, backlog: int = 64):
        self.fn = fn
        self.workers = workers
        self.backlog = backlog

    def __call__(self, items: Iterator) -> Iterator:
        import concurrent.futures as cf
        from collections import deque

        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = deque()
            for item in items:
                pending.append(pool.submit(self.fn, item))
                if len(pending) >= self.backlog:
                    yield from pending.popleft().result()
            while pending:
                yield from pending.popleft().result()


def _discover_wavs(root: pathlib.Path) -> List[str]:
    """Relative 'spk/yt/utt' keys for every wav under root."""
    return sorted(
        str(p.relative_to(root))[: -len(".wav")]
        for p in root.rglob("*.wav")
    )


class VoxCelebDataModule:
    def __init__(self, cfg: VoxCelebConfig):
        self.cfg = cfg
        if cfg.data_dir is not None:
            self.cfg.data_dir = pathlib.Path(cfg.data_dir)
        for f in ("voxceleb1_dev_dir", "voxceleb1_test_dir",
                  "voxceleb2_dev_dir", "voxceleb2_test_dir"):
            v = getattr(cfg, f)
            if v is not None:
                setattr(cfg, f, pathlib.Path(v))
        self.cfg.shards_dir = pathlib.Path(cfg.shards_dir)
        self._meta: Optional[Dict] = None

    def _corpus_sources(self) -> List[tuple]:
        """(root, is_train_source) corpus list (voxceleb.py:1494-1499:
        vc1-dev trains unless all_voxceleb1_is_test_set, vc2-dev trains,
        test corpora never do). Single-corpus `data_dir` is one dev root."""
        cfg = self.cfg
        sources = []
        if cfg.data_dir is not None:
            sources.append((cfg.data_dir, True))
        for root, use, is_train in (
            (cfg.voxceleb1_dev_dir, cfg.use_voxceleb1_dev,
             not cfg.all_voxceleb1_is_test_set),
            (cfg.voxceleb2_dev_dir, cfg.use_voxceleb2_dev, True),
            (cfg.voxceleb1_test_dir, cfg.use_voxceleb1_test, False),
            (cfg.voxceleb2_test_dir, cfg.use_voxceleb2_test, False),
        ):
            if root is not None and use:
                sources.append((root, is_train))
        if not sources:
            raise ValueError(
                "no corpus configured: set data_dir or voxceleb*_dir"
            )
        return sources

    # ------------------------------------------------------------ prepare

    def prepare_data(self) -> None:
        """One-time: extract -> split -> shard -> validate -> val pairs."""
        cfg = self.cfg
        out = cfg.shards_dir
        if (out / "prepared.json").exists():
            return
        out.mkdir(parents=True, exist_ok=True)

        # discover per corpus source; keys stay 'spk/yt/utt' with a
        # key -> corpus-root map for loading
        key_root: Dict[str, pathlib.Path] = {}
        trainable: Dict[str, bool] = {}
        for root, is_train in self._corpus_sources():
            keys_i = _discover_wavs(root)
            if not keys_i and root.exists():
                # raw distribution archives: concatenate parts + extract in
                # place, then resolve the nested wav/ root (reference runs
                # extract->split->shard from the zips, voxceleb.py:184-311)
                from .extract import effective_audio_root, extract_archives

                extract_archives(root)
                root = effective_audio_root(root)
                keys_i = _discover_wavs(root)
            for k in keys_i:
                if k in key_root:
                    raise ValueError(
                        f"sample {k} appears in multiple corpora "
                        f"({key_root[k]} and {root})"
                    )
                key_root[k] = root
                # per-utterance: audio from a test-only source never
                # trains — utterances whose speaker is not in the trial
                # file are dropped below (voxceleb.py:1513-1517), never
                # promoted into training (cross-corpus leakage)
                trainable[k] = is_train
        keys = sorted(key_root)
        if cfg.limit_samples:
            keys = keys[: cfg.limit_samples]
        if not keys:
            raise ValueError(
                "no wav files under "
                + ", ".join(str(r) for r, _ in self._corpus_sources())
            )

        # test split: every speaker appearing in the trial file (from any
        # corpus); non-trial speakers of test-only sources are dropped
        # (voxceleb.py:1513-1517)
        test_keys: List[str] = []
        if cfg.test_trial_path is not None:
            trial_pairs = load_evaluation_pairs(cfg.test_trial_path)
            test_speakers = {
                p.sample1_id.split("/")[0] for p in trial_pairs
            } | {p.sample2_id.split("/")[0] for p in trial_pairs}
            test_keys = [k for k in keys if k.split("/")[0] in test_speakers]
            keys = [
                k for k in keys
                if k.split("/")[0] not in test_speakers and trainable[k]
            ]
        else:
            keys = [k for k in keys if trainable[k]]

        train_keys, val_keys = self._split_train_val(keys)

        # write shard sets
        def to_samples(key_list, idx_map):
            for k in key_list:
                wav = load_raw_audio(key_root[k] / f"{k}.wav")
                yield SpeakerSample(
                    key=k, wav=wav, ground_truth=idx_map.get(k.split("/")[0], -1)
                )

        train_speakers = sorted({k.split("/")[0] for k in train_keys})
        idx_map = {s: i for i, s in enumerate(train_speakers)}

        for split, split_keys in (
            ("train", train_keys if cfg.has_train else []),
            ("val", val_keys if cfg.has_val else []),
            ("test", test_keys if cfg.has_test else []),
        ):
            if not split_keys:
                continue
            d = out / split
            write_speaker_shards(
                to_samples(split_keys, idx_map),
                d,
                samples_per_shard=cfg.samples_per_shard,
                sequential_same_speaker_samples=(
                    cfg.sequential_same_speaker_samples
                    if split == "train"
                    else 1
                ),
                min_unique_speakers_per_shard=(
                    cfg.min_unique_speakers_per_shard
                    if split == "train"
                    else 1
                ),
                use_gzip=cfg.use_gzip_compression,
                discard_partial_shards=(split == "train"),
                seed=cfg.seed,
            )

        self._assert_split_consistency(out)

        # validation pairs
        if val_keys and cfg.has_val:
            per_speaker: Dict[str, List[str]] = {}
            for k in val_keys:
                per_speaker.setdefault(k.split("/")[0], []).append(k)
            if len(per_speaker) >= 2:
                pairs = generate_validation_pairs(
                    per_speaker,
                    num_pairs=min(
                        self.cfg.eer_validation_pairs,
                        2 * len(val_keys),
                    ),
                    seed=cfg.seed,
                )
                save_evaluation_pairs(pairs, out / "val_pairs.txt")

        with open(out / "prepared.json", "w") as f:
            json.dump(
                {
                    "num_train": len(train_keys),
                    "num_val": len(val_keys),
                    "num_test": len(test_keys),
                    "num_speakers": len(train_speakers),
                },
                f,
            )

    def _split_train_val(self, keys: List[str]):
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        if cfg.train_val_split_mode == "different":
            # held-out speakers (voxceleb.py:1527-1579); either an exact
            # held-out count (num_val_speakers) or a ratio
            speakers = sorted({k.split("/")[0] for k in keys})
            rng.shuffle(speakers)
            if cfg.num_val_speakers and cfg.num_val_speakers > 0:
                n_train = max(1, len(speakers) - cfg.num_val_speakers)
            else:
                n_train = max(1, round(len(speakers) * cfg.train_val_ratio))
            train_spk = set(speakers[:n_train])
            train = [k for k in keys if k.split("/")[0] in train_spk]
            val = [k for k in keys if k.split("/")[0] not in train_spk]
            return train, val
        if cfg.train_val_split_mode == "equal":
            # per-speaker youtube-id ratio split (voxceleb.py:1582-1681):
            # val gets whole youtube sessions so train/val never share a
            # recording session
            by_spk_yt: Dict[str, Dict[str, List[str]]] = {}
            for k in keys:
                spk, yt = k.split("/")[0], k.split("/")[1]
                by_spk_yt.setdefault(spk, {}).setdefault(yt, []).append(k)
            train, val = [], []
            for spk in sorted(by_spk_yt):
                yts = sorted(by_spk_yt[spk])
                rng.shuffle(yts)
                n_total = sum(len(by_spk_yt[spk][y]) for y in yts)
                target_val = max(0, round(n_total * (1 - cfg.train_val_ratio)))
                taken = 0
                for y in yts:
                    bucket = by_spk_yt[spk][y]
                    if taken < target_val and len(yts) > 1:
                        val.extend(bucket)
                        taken += len(bucket)
                    else:
                        train.extend(bucket)
            return train, val
        raise ValueError(
            f"unknown train_val_split_mode {cfg.train_val_split_mode}"
        )

    @staticmethod
    def _assert_split_consistency(out: pathlib.Path) -> None:
        """Split disjointness + speaker-index agreement
        (voxceleb.py:313-341). Metadata-only like the reference check:
        streams keys via ``ShardReader.iter_keys`` — never decodes audio
        just to compare keys (at VoxCeleb2-dev scale a full read would
        roughly double one-time prepare I/O)."""
        seen: Dict[str, str] = {}
        idx_maps = []
        for split in ("train", "val", "test"):
            d = out / split
            if not d.exists():
                continue
            meta = read_meta(d)
            idx_maps.append((split, meta["speaker_id_to_idx"]))
            for key in ShardReader(ShardReader.discover(d)).iter_keys():
                if key in seen:
                    raise AssertionError(
                        f"sample {key} in both {seen[key]} and {split}"
                    )
                seen[key] = split

    # ------------------------------------------------------------ loaders

    @property
    def meta(self) -> Dict:
        if self._meta is None:
            self._meta = read_meta(self.cfg.shards_dir / "train")
        return self._meta

    @property
    def num_speakers(self) -> int:
        with open(self.cfg.shards_dir / "prepared.json") as f:
            return json.load(f)["num_speakers"]

    def val_evaluation_pairs(self) -> List[EvaluationPair]:
        path = self.cfg.shards_dir / "val_pairs.txt"
        return load_evaluation_pairs(path) if path.exists() else []

    def test_evaluation_pairs(self) -> List[EvaluationPair]:
        if self.cfg.test_trial_path is None:
            return []
        return load_evaluation_pairs(self.cfg.test_trial_path)

    def _speaker_idx_map(self) -> Dict[str, int]:
        return self.meta["speaker_id_to_idx"]

    def _pipeline(
        self,
        split: str,
        train: bool,
        chunk_strategy: Optional[str] = None,
        epoch: int = 0,
    ) -> Iterator[SpeakerSample]:
        cfg = self.cfg
        d = cfg.shards_dir / split
        # epoch-dependent seeds: shard order, chunk offsets and batch
        # composition must differ across epochs (the reference reshuffles
        # per epoch via DataLoader); large-prime stride keeps streams
        # disjoint from the val pipeline's seed+1
        eseed = cfg.seed + epoch * 9973 if train else cfg.seed
        reader = ShardReader(
            ShardReader.discover(d),
            shuffle_shards=cfg.shuffle_shards and train,
            seed=eseed,
            host_id=cfg.host_id,
            num_hosts=cfg.num_hosts,
        )
        selector = ChunkSelector(
            chunk_strategy or cfg.chunk_strategy, cfg.chunk_length_sec
        )
        rng = LockedGenerator(eseed + (0 if train else 1))
        idx_map = self._speaker_idx_map()

        def process_one(sample: SpeakerSample) -> List[SpeakerSample]:
            if sample.ground_truth < 0:
                sample.ground_truth = idx_map.get(
                    sample.key.split("/")[0], -1
                )
            if not np.isfinite(sample.wav).all():
                raise ValueError(f"NaN/inf in decoded sample {sample.key}")
            cap = cfg.debug_capture
            record = ((lambda stage, wav: cap.record(sample.key, stage, wav))
                      if cap is not None and cap.wants(sample.key) else None)
            if record is not None:
                record("original", sample.wav)
            processed = [sample]
            if train and cfg.augmenter is not None:
                processed = cfg.augmenter(sample, capture=record)
            out = []
            for s in processed:
                for ci, chunk in enumerate(selector(s.wav, rng)):
                    if record is not None:
                        record(f"chunk{ci}", chunk)
                    wav = normalize_waveform(chunk) if cfg.normalize_input else chunk
                    if record is not None and cfg.normalize_input:
                        record(f"normalize{ci}", wav)
                    out.append(SpeakerSample(s.key, wav.astype(np.float32), s.ground_truth, s.meta))
            return out

        if train and cfg.num_pipeline_workers > 1:
            yield from ParallelMap(
                process_one, workers=cfg.num_pipeline_workers
            )(iter(reader))
        else:
            for sample in reader:
                yield from process_one(sample)

    def train_batches(
        self, batch_processor=None, prefetch_depth: int = 4, epoch: int = 0
    ) -> Iterable[Dict]:
        cfg = self.cfg
        proc = batch_processor or RandomBatchProcessor(
            max_batch_size=cfg.batch_size,
            max_queue_size=cfg.queue_size,
            collate_fn=collate_speaker_batch,
            seed=cfg.seed + epoch * 9973,
        )
        return Prefetcher(
            lambda: proc(self._pipeline("train", train=True, epoch=epoch)),
            depth=prefetch_depth,
        )

    def val_batches(self, chunk_strategy: str = "start") -> Iterable[Dict]:
        """First-3s crops, sequential batches (the reference's val protocol:
        first-chunk crop, `wav2vec_base_pipeline.yaml`)."""
        cfg = self.cfg

        def gen():
            batch: List[SpeakerSample] = []
            for s in self._pipeline("val", train=False, chunk_strategy=chunk_strategy):
                batch.append(s)
                if len(batch) == cfg.batch_size:
                    yield collate_speaker_batch(batch)
                    batch = []
            if batch:
                yield collate_speaker_batch(batch)

        return Prefetcher(gen)

    def test_samples(self) -> Iterator[SpeakerSample]:
        """Full-length utterances for embedding extraction (the reference's
        bs=1 full-utterance protocol, here batched with masks by
        ``extract_embeddings``)."""
        cfg = self.cfg
        d = cfg.shards_dir / "test"
        reader = ShardReader(ShardReader.discover(d))
        for sample in reader:
            wav = (
                normalize_waveform(sample.wav)
                if cfg.normalize_input
                else sample.wav
            )
            yield SpeakerSample(
                sample.key, wav.astype(np.float32), sample.ground_truth,
                sample.meta,
            )

    def summary(self) -> str:
        with open(self.cfg.shards_dir / "prepared.json") as f:
            info = json.load(f)
        return (
            f"VoxCelebDataModule: {info['num_train']} train / "
            f"{info['num_val']} val / {info['num_test']} test samples, "
            f"{info['num_speakers']} train speakers"
        )
