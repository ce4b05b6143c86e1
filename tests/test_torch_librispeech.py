"""The port's LibriSpeech pipeline (``data/librispeech.py``,
``DynamicTokenBudgetBatcher``, ``collate_speech_batch``) against the JAX
package's, on a raw tree the test writes in LibriSpeech layout
(``<spk>/<chapter>/<spk>-<chapter>-<utt>.wav`` and ``.trans.txt``; one
utterance as FLAC, written by the JAX package's encoder): the same shard
files, keys in the same order, ``meta.json``, vocabulary and
``prepared.json``; shards each package reads from the other; and at one
seed the same training batches over two epochs, eval batches, speaker map
and trial pairs. Every comparison is exact: both packages run the same
numpy code on the same draws."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from w2v2_speaker_tpu.data import batching as jbatching
from w2v2_speaker_tpu.data import librispeech as jls
from w2v2_speaker_tpu.data import samples as jsamples
from w2v2_speaker_tpu.data import shards as jshards
from w2v2_speaker_tpu.utils.flac_encode import encode_flac
from w2v2_speaker_tpu_torch.data import batching as tbatching
from w2v2_speaker_tpu_torch.data import librispeech as tls
from w2v2_speaker_tpu_torch.data import samples as tsamples
from w2v2_speaker_tpu_torch.data import shards as tshards
from w2v2_speaker_tpu_torch.data.io import write_wav

SR = 16000
SPLITS = ("train", "val_clean", "test_clean")
CONFIG = dict(samples_per_shard=5, train_max_num_samples=40000, max_queue_size=7, pad_to_multiple=1600, seed=5)


def write_tree(root: pathlib.Path, n_spk=3, n_utt=5, seed=0, flac: bool = False) -> pathlib.Path:
    """``n_spk`` speakers x 2 chapters x ``n_utt`` utterances of 0.3-1.6 s,
    transcripts of random words; with ``flac`` the first utterance is
    16-bit FLAC."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ'"))
    for s in range(n_spk):
        for c in range(2):
            spk, chap = 100 + 7 * s + seed, 2000 + c
            d = root / f"{spk}" / f"{chap}"
            d.mkdir(parents=True, exist_ok=True)
            lines = []
            for u in range(n_utt):
                utt = f"{spk}-{chap}-{u:04d}"
                wav = rng.normal(0, 0.1, int(SR * rng.uniform(0.3, 1.6))).astype(np.float32)
                if flac and s == c == u == 0:
                    (d / f"{utt}.flac").write_bytes(encode_flac(np.round(wav * 32767).astype(np.int32)))
                else:
                    write_wav(d / f"{utt}.wav", wav, SR)
                words = " ".join("".join(rng.choice(letters, rng.integers(1, 8))) for _ in range(rng.integers(1, 6)))
                lines.append(f"{utt} {words}")
            (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("librispeech")
    return {split: write_tree(tmp / "raw" / split, seed=i, flac=split == "train") for i, split in enumerate(SPLITS)}


@pytest.fixture(scope="module")
def modules(trees, tmp_path_factory):
    """Both packages' prepared modules over the same raw splits."""
    tmp = tmp_path_factory.mktemp("librispeech_shards")
    out = {}
    for name, mod in (("jax", jls), ("torch", tls)):
        dm = mod.LibriSpeechDataModule(mod.LibriSpeechConfig(split_dirs=dict(trees), shards_dir=tmp / name, **CONFIG))
        dm.prepare_data()
        out[name] = dm
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


def test_shards_meta_and_vocabulary_match_jax(modules):
    jdir, tdir = (modules[n].cfg.shards_dir for n in ("jax", "torch"))
    for name in ("vocab.json", "prepared.json"):
        assert json.loads((tdir / name).read_text()) == json.loads((jdir / name).read_text()), name
    for split in SPLITS:
        assert sorted(p.name for p in (tdir / split).iterdir()) == sorted(p.name for p in (jdir / split).iterdir())
        assert json.loads((tdir / split / "meta.json").read_text()) == json.loads((jdir / split / "meta.json").read_text())
        paths = tshards.ShardReader.discover(tdir / split)
        got = list(tshards.ShardReader(paths))
        want = list(jshards.ShardReader(jshards.ShardReader.discover(jdir / split)))
        assert [s.key for s in got] == [s.key for s in want]
        lengths = [s.wav.shape[-1] for s in got]
        assert lengths == sorted(lengths)  # length-sorted sharding
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.wav, w.wav)
            assert g.meta == w.meta
        # each package reads the other's shards
        assert [s.key for s in tshards.ShardReader(tshards.ShardReader.discover(jdir / split))] == [s.key for s in got]
    assert modules["torch"].tokenizer.vocab == modules["jax"].tokenizer.vocab
    modules["torch"].vocabulary_consistency_check()


def test_flac_utterance_is_decoded(modules, trees):
    flac = next(trees["train"].rglob("*.flac"))
    sample = next(s for s in tshards.ShardReader(tshards.ShardReader.discover(modules["torch"].cfg.shards_dir / "train"))
                  if s.key == flac.stem)
    assert sample.wav.dtype == np.float32 and sample.wav.size > 0 and np.abs(sample.wav).max() < 1


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_batches_match_jax(modules, epoch):
    got = list(modules["torch"].train_batches(epoch=epoch))
    want = list(modules["jax"].train_batches(epoch=epoch))
    _assert_batches_equal(got, want)
    for b in got:  # rows x the longest row within the budget, labels padded to a multiple of 8
        assert len(b["keys"]) * b["mask"].sum(-1).max() <= CONFIG["train_max_num_samples"]
        assert b["labels"].shape[1] % 8 == 0
        assert "speaker_labels" not in b
    assert sum(len(b["keys"]) for b in got) == 30
    if epoch == 1:
        assert [b["keys"] for b in got] != [b["keys"] for b in modules["torch"].train_batches(epoch=0)]


@pytest.mark.parametrize("split, batch_size", [("val_clean", 8), ("test_clean", 4)])
def test_eval_batches_match_jax(modules, split, batch_size):
    _assert_batches_equal(list(modules["torch"].eval_batches(split, batch_size=batch_size)),
                          list(modules["jax"].eval_batches(split, batch_size=batch_size)))


def test_speakers_and_pairs_match_jax(modules, tmp_path):
    t, j = modules["torch"], modules["jax"]
    assert t.speaker_id_to_idx == j.speaker_id_to_idx and t.num_speakers == j.num_speakers == 3
    pairs = [[dataclasses.astuple(p) for p in m.val_evaluation_pairs("val_clean", 12)] for m in (t, j)]
    assert pairs[0] == pairs[1] and len(pairs[0]) == 12
    cfg = dataclasses.replace(t.cfg, with_speaker_labels=True)
    labelled = tls.LibriSpeechDataModule(cfg)
    jlabelled = jls.LibriSpeechDataModule(jls.LibriSpeechConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    _assert_batches_equal(list(labelled.train_batches()), list(jlabelled.train_batches()))
    assert all("speaker_labels" in b for b in labelled.train_batches())
    # a shard set without speakers in its meta: the keys are scanned once
    meta = json.loads((cfg.shards_dir / "train" / "meta.json").read_text())
    no_field = tmp_path / "train"
    no_field.mkdir()
    for p in (cfg.shards_dir / "train").glob("*.tar"):
        (no_field / p.name).write_bytes(p.read_bytes())
    (no_field / "meta.json").write_text(json.dumps({k: v for k, v in meta.items() if k != "speakers"}))
    old = tls.LibriSpeechDataModule(dataclasses.replace(t.cfg, shards_dir=tmp_path))
    assert old.speaker_id_to_idx == t.speaker_id_to_idx and (no_field / "speakers.json").exists()


def test_fixed_tokenizer_and_unported_capture(modules):
    cfg = dataclasses.replace(modules["torch"].cfg, tokenizer_name="wav2vec2_base_960h")
    tok = tls.LibriSpeechDataModule(cfg).tokenizer
    assert tok.vocab == jls.LibriSpeechDataModule(jls.LibriSpeechConfig(
        shards_dir=cfg.shards_dir, tokenizer_name="wav2vec2_base_960h")).tokenizer.vocab
    captured = []  # the capture, once unported, is taken; preparing and checking the vocabulary record nothing
    capture = type("Capture", (), {"wants": lambda self, key: True,
                                   "record": lambda self, *a, **kw: captured.append(a),
                                   "record_text": lambda self, *a: captured.append(a)})()
    dm = tls.LibriSpeechDataModule(dataclasses.replace(modules["torch"].cfg, debug_capture=capture))
    dm.vocabulary_consistency_check()
    assert dm.cfg.debug_capture is capture and not captured
    with pytest.raises(ValueError, match="no transcribed wavs"):
        tls.write_librispeech_shards(modules["torch"].cfg.shards_dir / "train", modules["torch"].cfg.shards_dir / "x")


@pytest.mark.parametrize("budget, queue, max_rows", [(20000, 6, None), (40000, 50, None), (40000, 9, 2),
                                                      (9000, 4, None)])
def test_token_budget_batcher_matches_jax(budget, queue, max_rows, capsys):
    """Random lengths through both batchers at one seed: the same batches
    in the same order; a sample over the budget is skipped with a line."""
    rng = np.random.default_rng(budget + queue)
    lengths = rng.integers(800, 12000, 40)
    texts = ["A B", "CD", "E", "FGH I"]

    def samples(mod):
        return [mod.SpeechSample(f"s{i}", np.full(n, i, np.float32), texts[i % 4], np.arange(1, 2 + i % 5))
                for i, n in enumerate(lengths)]

    batches = []
    for batching, samp in ((tbatching, tsamples), (jbatching, jsamples)):
        proc = batching.DynamicTokenBudgetBatcher(budget, queue, lambda s, samp=samp: samp.collate_speech_batch(
            s, pad_to_multiple=1600), max_batch_size=max_rows, seed=3)
        batches.append(list(proc(samples(samp))))
    _assert_batches_equal(*batches)
    if max_rows:
        assert max(len(b["keys"]) for b in batches[0]) <= max_rows
    skipped = capsys.readouterr().out.count("skipping over-budget sample")
    assert skipped == 2 * int((lengths > budget).sum())
    assert sum(len(b["keys"]) for b in batches[0]) == int((lengths <= budget).sum())
