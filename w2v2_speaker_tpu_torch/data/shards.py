"""Tar-shard storage of a speaker corpus: the port's copy of
``w2v2_speaker_tpu/data/shards.py`` (``ShardWriter`` :39,
``write_speaker_shards`` :72, ``read_meta`` :189, ``ShardReader`` :194).

The layout is the JAX package's, so each package reads the other's shards:
one tar (``.tar``, or ``.tar.gz`` with gzip) per shard, holding per sample
``<key>.npy`` (float32 waveform, ``/`` in the key written as ``__``) and
``<key>.json`` (the key and its metadata), and a ``meta.json`` beside the
shards with the sample and speaker counts and the ``speaker_id_to_idx``
map. Samples are grouped in runs of ``sequential_same_speaker_samples``
from one speaker, a shard needs ``min_unique_speakers_per_shard`` distinct
speakers, and a trailing partial shard is dropped on request. Every
shuffle is drawn from a seeded numpy generator in the JAX package's order.
"""

from __future__ import annotations

import io
import json
import pathlib
import tarfile
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np

from .samples import SpeakerSample

__all__ = ["ShardWriter", "ShardReader", "write_speaker_shards", "read_meta"]


class ShardWriter:
    """Write one tar(.gz) shard of (key, wav, meta) samples."""

    def __init__(self, path: pathlib.Path | str, use_gzip: bool = False):
        self.path = pathlib.Path(path)
        self.use_gzip = use_gzip
        self._tar = tarfile.open(self.path, "w:gz" if use_gzip else "w")
        self.count = 0

    def write(self, key: str, wav: np.ndarray, meta: Dict) -> None:
        safe = key.replace("/", "__")
        wav_bytes = io.BytesIO()
        np.save(wav_bytes, np.asarray(wav, np.float32))
        self._add(f"{safe}.npy", wav_bytes.getvalue())
        self._add(f"{safe}.json", json.dumps({"key": key, **meta}).encode("utf-8"))
        self.count += 1

    def _add(self, name: str, payload: bytes) -> None:
        info = tarfile.TarInfo(name=name)
        info.size = len(payload)
        self._tar.addfile(info, io.BytesIO(payload))

    def close(self) -> None:
        self._tar.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _write_shard(path: pathlib.Path, runs: Sequence[List[SpeakerSample]], use_gzip: bool,
                 speaker_id_to_idx: Dict[str, int], sample_rate: int) -> int:
    """One shard of ``runs``; returns the samples written."""
    written = 0
    with ShardWriter(path, use_gzip=use_gzip) as w:
        for run in runs:
            for s in run:
                spk, yt, utt = (s.key.split("/") + ["", ""])[:3]
                w.write(s.key, s.wav, {
                    "speaker_id": spk,
                    "youtube_id": yt,
                    "utterance_id": utt,
                    "speaker_id_idx": speaker_id_to_idx[spk],
                    "num_frames": int(np.asarray(s.wav).shape[-1]),
                    "sampling_rate": sample_rate,
                })
                written += 1
    return written


def write_speaker_shards(
    samples: Iterable[SpeakerSample],
    out_dir: pathlib.Path | str,
    samples_per_shard: int = 100,
    sequential_same_speaker_samples: int = 1,
    min_unique_speakers_per_shard: int = 1,
    use_gzip: bool = False,
    discard_partial_shards: bool = True,
    name: str = "shard",
    seed: int = 0,
    sample_rate: int = 16000,
) -> Dict:
    """Write ``samples`` as shards under ``out_dir`` and return the meta
    dict that ``meta.json`` holds."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    k = sequential_same_speaker_samples

    per_speaker: Dict[str, List[SpeakerSample]] = {}
    for s in samples:
        per_speaker.setdefault(s.key.split("/")[0], []).append(s)
    speaker_ids = sorted(per_speaker)
    speaker_id_to_idx = {spk: i for i, spk in enumerate(speaker_ids)}

    runs: List[List[SpeakerSample]] = []
    for spk in speaker_ids:
        lst = list(per_speaker[spk])
        rng.shuffle(lst)
        usable = (len(lst) // k) * k
        runs.extend(lst[i : i + k] for i in range(0, usable, k))
    runs = [runs[i] for i in rng.permutation(len(runs))]

    if samples_per_shard % k != 0:
        raise ValueError(
            f"samples_per_shard={samples_per_shard} must be divisible by "
            f"sequential_same_speaker_samples={k}"
        )
    runs_per_shard = samples_per_shard // k
    suffix = ".tar.gz" if use_gzip else ".tar"

    shards_written = samples_written = i = 0
    while i + runs_per_shard <= len(runs):
        shard_runs = runs[i : i + runs_per_shard]
        i += runs_per_shard
        if len({r[0].key.split("/")[0] for r in shard_runs}) < min_unique_speakers_per_shard:
            continue  # a degenerate shard
        samples_written += _write_shard(out_dir / f"{name}-{shards_written:06d}{suffix}", shard_runs,
                                        use_gzip, speaker_id_to_idx, sample_rate)
        shards_written += 1
    if len(runs) > i and not discard_partial_shards:
        samples_written += _write_shard(out_dir / f"{name}-{shards_written:06d}{suffix}", runs[i:],
                                        use_gzip, speaker_id_to_idx, sample_rate)
        shards_written += 1

    meta = {
        "num_shards": shards_written,
        "num_samples": samples_written,
        "num_speakers": len(speaker_ids),
        "speaker_id_to_idx": speaker_id_to_idx,
        "samples_per_shard": samples_per_shard,
        "sequential_same_speaker_samples": k,
    }
    with open(out_dir / "meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def read_meta(shard_dir: pathlib.Path | str) -> Dict:
    with open(pathlib.Path(shard_dir) / "meta.json") as f:
        return json.load(f)


def _open(path: str) -> tarfile.TarFile:
    return tarfile.open(path, "r:gz" if path.endswith(".gz") else "r")


class ShardReader:
    """Stream ``SpeakerSample``s from tar shards. ``host_id`` /
    ``num_hosts`` select a disjoint subset of the shards; with
    ``shuffle_shards`` the shard order is reshuffled each epoch from
    ``seed + epoch``."""

    def __init__(self, shard_paths: Sequence[pathlib.Path | str], shuffle_shards: bool = False,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        paths = sorted(str(p) for p in shard_paths)
        if not paths:
            raise ValueError("no shard paths given")
        self.all_paths = paths
        self.paths = paths[host_id::num_hosts]
        self.shuffle_shards = shuffle_shards
        self.seed = seed
        self.epoch = 0

    @staticmethod
    def discover(shard_dir: pathlib.Path | str, pattern: str = "*.tar*"):
        return sorted(p for p in pathlib.Path(shard_dir).glob(pattern) if not p.name.endswith(".json"))

    def __iter__(self) -> Iterator[SpeakerSample]:
        paths = list(self.paths)
        if self.shuffle_shards:
            np.random.default_rng(self.seed + self.epoch).shuffle(paths)
        self.epoch += 1
        for path in paths:
            yield from self._read_shard(path)

    @staticmethod
    def _read_shard(path: str) -> Iterator[SpeakerSample]:
        with _open(path) as tar:
            pending_wav: Dict[str, np.ndarray] = {}
            pending_meta: Dict[str, Dict] = {}
            for member in tar:
                if not member.isfile():
                    continue
                stem, ext = member.name.rsplit(".", 1)
                payload = tar.extractfile(member).read()
                if ext == "npy":
                    pending_wav[stem] = np.load(io.BytesIO(payload))
                elif ext == "json":
                    pending_meta[stem] = json.loads(payload)
                if stem in pending_wav and stem in pending_meta:
                    meta = pending_meta.pop(stem)
                    yield SpeakerSample(key=meta["key"], wav=pending_wav.pop(stem),
                                        ground_truth=meta.get("speaker_id_idx", -1), meta=meta)

    def iter_keys(self) -> Iterator[str]:
        """The sample keys alone, from the ``.json`` members: no waveform
        is decoded."""
        for path in self.paths:
            with _open(path) as tar:
                for member in tar:
                    if member.isfile() and member.name.endswith(".json"):
                        yield json.loads(tar.extractfile(member).read())["key"]
