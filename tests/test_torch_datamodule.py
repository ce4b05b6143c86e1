"""The port's data pipeline (``data/{chunks,shards,batching,extract,
datamodule}.py``, ``collate_speaker_batch``, ``LockedGenerator``) against
the JAX package's, on a WAV tree the test writes: the same preparation
(``prepared.json``, splits, shard metadata, validation pairs), shards that
each package reads from the other, and the same train batches (two
epochs), validation batches and test samples at one seed. Every
comparison is exact: both packages run the same numpy code on the same
draws."""

import dataclasses
import json
import pathlib
import tarfile
import zipfile

import numpy as np
import pytest

from w2v2_speaker_tpu.data import batching as jbatching
from w2v2_speaker_tpu.data import chunks as jchunks
from w2v2_speaker_tpu.data import datamodule as jdm
from w2v2_speaker_tpu.data import extract as jextract
from w2v2_speaker_tpu.data import samples as jsamples
from w2v2_speaker_tpu.data import shards as jshards
from w2v2_speaker_tpu.data.augment import LockedGenerator as JaxLockedGenerator
from w2v2_speaker_tpu_torch.data import augment as taugment
from w2v2_speaker_tpu_torch.data import batching as tbatching
from w2v2_speaker_tpu_torch.data import chunks as tchunks
from w2v2_speaker_tpu_torch.data import datamodule as tdm
from w2v2_speaker_tpu_torch.data import extract as textract
from w2v2_speaker_tpu_torch.data import samples as tsamples
from w2v2_speaker_tpu_torch.data import shards as tshards
from w2v2_speaker_tpu_torch.data.io import write_wav

SR = 16000
CONFIG = dict(  # VoxCelebConfig fields both packages take
    train_val_split_mode="equal", train_val_ratio=0.7, samples_per_shard=6, batch_size=4,
    queue_size=10, chunk_length_sec=1.0, eer_validation_pairs=8, seed=11,
)


def write_corpus(root: pathlib.Path, n_spk=6, n_yt=3, n_utt=2, test_spk=2, seed=0):
    """``idNNNNN/ytY/NNNNN.wav`` files of 1.1-2.2 s (seeded noise over a
    speaker's tones) and a trial file over the last ``test_spk`` speakers;
    returns (wav root, trial file)."""
    rng = np.random.default_rng(seed)
    wav_dir = root / "wav"
    for s in range(n_spk):
        freqs = rng.uniform(150, 3000, 3)
        for y in range(n_yt):
            for u in range(n_utt):
                t = np.arange(int(SR * rng.uniform(1.1, 2.2))) / SR
                wav = 0.1 * sum(np.sin(2 * np.pi * f * t) for f in freqs) + rng.normal(0, 0.1, t.shape)
                path = wav_dir / f"id{s:05d}/yt{y}/{u:05d}.wav"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_wav(path, wav.astype(np.float32), SR)
    test_ids = [f"id{s:05d}" for s in range(n_spk - test_spk, n_spk)]
    lines = []
    for i, spk in enumerate(test_ids):
        lines.append(f"1 {spk}/yt0/00000.wav {spk}/yt1/00001.wav")
        lines.append(f"0 {spk}/yt0/00000.wav {test_ids[(i + 1) % len(test_ids)]}/yt2/00001.wav")
    trials = root / "trials.txt"
    trials.write_text("\n".join(lines) + "\n")
    return wav_dir, trials


def _modules(root, wav_dir, trials, **overrides):
    kw = {**CONFIG, "data_dir": wav_dir, "test_trial_path": trials, **overrides}
    jax_dm = jdm.VoxCelebDataModule(jdm.VoxCelebConfig(shards_dir=root / "jax_shards", **kw))
    torch_dm = tdm.VoxCelebDataModule(tdm.VoxCelebConfig(shards_dir=root / "torch_shards", **kw))
    jax_dm.prepare_data()
    torch_dm.prepare_data()
    return jax_dm, torch_dm


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_datamodule")
    wav_dir, trials = write_corpus(root)
    return (root, wav_dir, trials, *_modules(root, wav_dir, trials))


def _files(d: pathlib.Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_preparation_matches_jax(prepared):
    """The same ``prepared.json``, split shard sets (file names and bytes),
    shard ``meta.json`` files and validation pairs."""
    root, _, _, jax_dm, torch_dm = prepared
    jd, td = root / "jax_shards", root / "torch_shards"
    assert _files(td) == _files(jd)
    assert {"prepared.json", "val_pairs.txt", "train/meta.json", "val/meta.json", "test/meta.json"} <= set(_files(td))
    for rel in _files(jd):
        assert (td / rel).read_bytes() == (jd / rel).read_bytes(), rel
    info = json.loads((td / "prepared.json").read_text())
    assert info["num_test"] == 2 * 3 * 2 and info["num_train"] + info["num_val"] == 4 * 3 * 2
    assert torch_dm.num_speakers == jax_dm.num_speakers == 4
    assert torch_dm.summary() == jax_dm.summary()
    want = [dataclasses.astuple(p) for p in jax_dm.val_evaluation_pairs()]
    assert [dataclasses.astuple(p) for p in torch_dm.val_evaluation_pairs()] == want and len(want) == 8
    assert [dataclasses.astuple(p) for p in torch_dm.test_evaluation_pairs()] == [
        dataclasses.astuple(p) for p in jax_dm.test_evaluation_pairs()]


@pytest.mark.parametrize("mode", ["equal", "different"])
def test_train_val_split_matches_jax(prepared, mode):
    _, wav_dir, trials, jax_dm, torch_dm = prepared
    keys = sorted(str(p.relative_to(wav_dir))[:-4] for p in wav_dir.rglob("*.wav"))
    jax_dm.cfg.train_val_split_mode = torch_dm.cfg.train_val_split_mode = mode
    try:
        assert torch_dm._split_train_val(keys) == jax_dm._split_train_val(keys)
    finally:
        jax_dm.cfg.train_val_split_mode = torch_dm.cfg.train_val_split_mode = "equal"


def _read_all(reader):
    return [(s.key, s.wav, s.ground_truth, s.meta) for s in reader]


@pytest.mark.parametrize("use_gzip", [False, True])
def test_each_package_reads_the_others_shards(tmp_path, use_gzip):
    """Shards written by one package read back bit for bit through the
    other's ``ShardReader`` (waveforms, labels, metadata, keys), plain tar
    and gzip."""
    rng = np.random.default_rng(3)
    keys = [f"id{s:05d}/yt{y}/{u:05d}" for s in range(3) for y in range(2) for u in range(2)]
    wavs = {k: rng.normal(0, 1, int(rng.integers(500, 900))).astype(np.float32) for k in keys}
    kw = dict(samples_per_shard=4, use_gzip=use_gzip, seed=5, discard_partial_shards=False)
    meta_j = jshards.write_speaker_shards([jsamples.SpeakerSample(k, w, -1) for k, w in wavs.items()],
                                          tmp_path / "jax", **kw)
    meta_t = tshards.write_speaker_shards([tsamples.SpeakerSample(k, w) for k, w in wavs.items()],
                                          tmp_path / "torch", **kw)
    assert meta_t == meta_j and meta_t["num_samples"] == len(keys)
    suffix = ".tar.gz" if use_gzip else ".tar"
    paths = {name: tshards.ShardReader.discover(tmp_path / name) for name in ("jax", "torch")}
    assert all(p.name.endswith(suffix) for p in paths["torch"]) and len(paths["torch"]) == 3
    for writer in ("jax", "torch"):
        by_jax = _read_all(jshards.ShardReader(paths[writer]))
        by_torch = _read_all(tshards.ShardReader(paths[writer]))
        assert len(by_torch) == len(keys)
        for (k, w, g, m), (k2, w2, g2, m2) in zip(by_torch, by_jax, strict=True):
            assert (k, g, m) == (k2, g2, m2) and w.dtype == np.float32
            np.testing.assert_array_equal(w, w2)
            np.testing.assert_array_equal(w, wavs[k])
        assert list(tshards.ShardReader(paths[writer]).iter_keys()) == [r[0] for r in by_torch]
    # the shard order of every epoch (shuffled per epoch, split per host)
    for host in (0, 1):
        jr = jshards.ShardReader(paths["jax"], shuffle_shards=True, seed=4, host_id=host, num_hosts=2)
        tr = tshards.ShardReader(paths["jax"], shuffle_shards=True, seed=4, host_id=host, num_hosts=2)
        for _ in range(3):
            assert [s.key for s in tr] == [s.key for s in jr]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["keys"] == w["keys"]
        for key in ("features", "labels", "mask"):
            if key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])


def test_train_batches_match_jax_for_two_epochs(prepared):
    """Random 1 s crops, normalised, drawn into batches of 4 from a queue
    of 10: features, labels and keys equal for epochs 0 and 1, and the
    two epochs differ."""
    _, _, _, jax_dm, torch_dm = prepared
    epochs = []
    for epoch in (0, 1):
        want = list(jax_dm.train_batches(epoch=epoch))
        got = list(torch_dm.train_batches(epoch=epoch))
        _assert_batches_equal(got, want)
        assert got[0]["features"].shape == (4, SR) and "mask" not in got[0]
        epochs.append([k for b in got for k in b["keys"]])
    assert sorted(epochs[0]) == sorted(epochs[1]) and epochs[0] != epochs[1]


def test_val_batches_and_test_samples_match_jax(prepared):
    _, _, _, jax_dm, torch_dm = prepared
    _assert_batches_equal(list(torch_dm.val_batches()), list(jax_dm.val_batches()))
    want = list(jax_dm.test_samples())
    got = list(torch_dm.test_samples())
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g.key, g.ground_truth) == (w.key, w.ground_truth) and g.wav.shape[0] > SR
        np.testing.assert_array_equal(g.wav, w.wav)


def test_parallel_pipeline_and_limit_samples_match_jax(tmp_path):
    """Four pipeline threads and ``limit_samples``: the same batches as the
    JAX package's. Threads take the crop draws in the order they reach the
    lock, so the crops are the deterministic ``start`` ones here; the
    threads keep the sample order."""
    wav_dir, trials = write_corpus(tmp_path, n_spk=5, test_spk=2, seed=2)
    jax_dm, torch_dm = _modules(tmp_path, wav_dir, trials, num_pipeline_workers=4, limit_samples=24,
                                eer_validation_pairs=4, chunk_strategy="start")
    assert torch_dm.summary() == jax_dm.summary()
    _assert_batches_equal(list(torch_dm.train_batches(epoch=1)), list(jax_dm.train_batches(epoch=1)))


@pytest.mark.parametrize("strategy", ["start", "end", "random", "random_contiguous", "contiguous"])
def test_chunk_selector_matches_jax(strategy):
    wav = np.random.default_rng(0).normal(size=5000).astype(np.float32)
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        want = jchunks.ChunkSelector(strategy, 0.1)(wav, jrng)
        got = tchunks.ChunkSelector(strategy, 0.1)(wav, trng)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tchunks.ChunkSelector(strategy, None)(wav)[0] is wav


def test_random_batch_processor_and_collate_match_jax():
    rng = np.random.default_rng(1)
    lengths = rng.integers(300, 700, 23)
    jax_s = [jsamples.SpeakerSample(f"s{i}", rng.normal(size=n).astype(np.float32), i % 5)
             for i, n in enumerate(lengths)]
    torch_s = [tsamples.SpeakerSample(s.key, s.wav, s.ground_truth) for s in jax_s]
    want = list(jbatching.RandomBatchProcessor(4, 9, jsamples.collate_speaker_batch, seed=3)(jax_s))
    got = list(tbatching.RandomBatchProcessor(4, 9, tsamples.collate_speaker_batch, seed=3)(torch_s))
    _assert_batches_equal(got, want)
    assert "mask" in got[0] and len(got) == 6
    with pytest.raises(ValueError, match="queue size"):
        tbatching.RandomBatchProcessor(4, 3, tsamples.collate_speaker_batch)


def test_locked_generator_draws_as_numpy():
    got, want = taugment.LockedGenerator(5), JaxLockedGenerator(5)
    assert [got.integers(0, 100) for _ in range(5)] == [want.integers(0, 100) for _ in range(5)]
    np.testing.assert_array_equal(got.normal(size=4), want.normal(size=4))


def test_prefetcher_raises_the_producers_error_and_releases_it():
    def gen():
        yield {"a": 1}
        raise ValueError("broken shard")

    it = iter(tdm.Prefetcher(gen, depth=1))
    assert next(it) == {"a": 1}
    with pytest.raises(ValueError, match="broken shard"):
        next(it)
    # an abandoned consumer stops the producer thread
    endless = tdm.Prefetcher(lambda: iter(lambda: {"b": 2}, None), depth=2)
    for i, item in enumerate(endless):
        if i == 3:
            break
    assert list(tdm.ParallelMap(lambda x: [x, -x], workers=3, backlog=2)(iter(range(5)))) == [
        0, 0, 1, -1, 2, -2, 3, -3, 4, -4]


def test_archive_extraction_matches_jax(tmp_path):
    """A zip split into ``_parta?`` parts and a tar.gz under a corpus root:
    the same concatenation, extraction (once) and nested audio root as the
    JAX package's; ``prepare_data`` finds the extracted WAVs."""
    wav_dir, trials = write_corpus(tmp_path / "src", n_spk=4, n_yt=2, test_spk=2)
    wavs = sorted(wav_dir.rglob("*.wav"))

    def write_archives(root):
        root.mkdir()
        blob = tmp_path / "all.zip"
        with zipfile.ZipFile(blob, "w") as z:
            for p in wavs[:6]:
                z.write(p, f"wav/{p.relative_to(wav_dir)}")
        data = blob.read_bytes()
        (root / "vox_dev_wav_partaa").write_bytes(data[: len(data) // 2])
        (root / "vox_dev_wav_partab").write_bytes(data[len(data) // 2 :])
        with tarfile.open(root / "extra.tar.gz", "w:gz") as t:
            for p in wavs[6:]:
                t.add(p, f"wav/{p.relative_to(wav_dir)}")
        return root

    for name, extract in (("jax", jextract), ("torch", textract)):
        root = write_archives(tmp_path / name)
        done = extract.extract_archives(root)
        assert [a.name for a in done] == ["vox_dev_wav.zip", "extra.tar.gz"]
        assert extract.extract_archives(root) == []
        assert extract.effective_audio_root(root) == root / "wav"
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    dm = tdm.VoxCelebDataModule(tdm.VoxCelebConfig(
        data_dir=write_archives(tmp_path / "fresh"), shards_dir=tmp_path / "torch_shards",
        test_trial_path=trials, **{**CONFIG, "samples_per_shard": 2, "eer_validation_pairs": 4}))
    dm.prepare_data()
    assert json.loads((tmp_path / "torch_shards" / "prepared.json").read_text())["num_test"] == 8
