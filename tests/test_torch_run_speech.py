"""The run twin on the CTC recipes end to end on the CPU against the JAX
package's ``run.main``, both from the same parameters (the JAX model's,
saved with ``save_params`` and exported with
``tools/export_jax_params.py``), tiny networks in float32 with dropout,
layerdrop and masking at 0:

- ``+experiment=speech_wav2vec2_ctc`` on a LibriSpeech-layout tree the test
  writes (train, val and test clean and other): token-budget batches in two
  buckets (steps 1-4: 2 x 9600, 2 x 9600, 2 x 6400, 2 x 6400 samples), a
  sanity validation, validations every 2 steps with the tracked
  transcription, best-k by ``val_wer``, the test WER;
- ``+experiment=speaker_wav2vec2_ctc`` (frame-level CTC over the speakers +
  a blank, 2 steps in one dispatch) on ``test_torch_run_paired``'s
  VoxCeleb-layout corpus of 0.2-0.3 s utterances, tested with mean pooling. Its schedule spans ``max_steps=4`` and
  one epoch of 2 batches ends the run: the JAX package's one-cycle rate
  (optax's) is NaN at every step when ``max_steps`` < 1 / pct_start, and its
  ``ctc_loss`` then scores the NaN logits 0 (the port's rates stay finite
  there).

Limits: the first step's loss rel 1e-6 (the same weights and batch; the
CTC losses of untrained models are ~100-300 a token, so an absolute 1e-5 is
below float32's spacing there), the later steps' rel 1e-4: Adam's first
updates are about lr x sign(g), and a weight whose CTC gradient is within
float32 CTC's error of 0 (~5e-4 on the head's bias, the same in optax and
torch against a float64 CTC) may move the other way. Read as built at
steps 2-4: 7.7e-6, 1.7e-5, 7.1e-5 to 7.4e-5 (1, 3 and all of the host's
threads). With one fault planted in the port's update: every rate halved
2.4e-2 / 5.2e-2 / 2.5e-2; no update at step 2: 4.8e-2 at step 3; the
tri-stage decay one step short (a third rate of 1e-5 for 2.15e-5): 3.5e-3
at step 4, 35x the limit. Transcriptions, WERs, EER and minDCF exact (the same
greedy decode and scores of float32 logits that differ by ~1e-6); EER
thresholds 1e-5; the speaker-CTC losses (~93 a row) rel 1e-6."""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_run import Recorder, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from test_torch_run_paired import write_corpus as write_voxceleb

from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu.runtime import logging as jlogging
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data.io import write_wav
from w2v2_speaker_tpu_torch.runtime import logging as tlogging

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
FIRST_RTOL, LOSS_RTOL = 1e-6, 1e-4
TINY = ["network.wav2vec2_size=tiny", "network.layerdrop=0.0", "network.hidden_dropout=0.0",
        "network.attention_dropout=0.0", "network.feat_proj_dropout=0.0", "network.mask_time_prob=0.0",
        "trainer.precision=f32", "trainer.log_every=1", "trainer.log_dir=null"]
SPLITS = (("train", "train_dir", 9), ("val_clean", "val_clean_dir", 3), ("val_other", "val_other_dir", 3),
          ("test_clean", "test_clean_dir", 3), ("test_other", "test_other_dir", 3))


def write_librispeech(root: pathlib.Path) -> dict:
    """Per split, utterances of 0.3-0.45 s (tones under noise) over 2
    speakers, with transcripts of 1-3 words from a small lexicon."""
    rng = np.random.default_rng(9)
    lexicon = ["A", "BE", "CAB", "DEAD", "ABBA", "ACE"]
    dirs = {}
    for i, (split, key, n) in enumerate(SPLITS):
        for u in range(n):
            spk, chap = 10 + 2 * i + u % 2, 300
            d = root / split / f"{spk}" / f"{chap}"
            d.mkdir(parents=True, exist_ok=True)
            utt = f"{spk}-{chap}-{u:04d}"
            t = np.arange(int(SR * rng.uniform(0.3, 0.45))) / SR
            write_wav(d / f"{utt}.wav", (0.3 * np.sin(2 * np.pi * 440 * (1 + u % 3) * t)
                                         + rng.normal(0, 0.2, t.shape)).astype(np.float32), SR)
            with open(d / f"{spk}-{chap}.trans.txt", "a") as f:
                f.write(f"{utt} {' '.join(rng.choice(lexicon, rng.integers(1, 4)))}\n")
        dirs[key] = root / split
    return dirs


def speech_overrides(dirs, out: pathlib.Path, *extra):
    return [
        "+experiment=speech_wav2vec2_ctc", *TINY, *(f"data.module.{k}={v}" for k, v in dirs.items()),
        "network.head_dropout=0.0", f"data.module.shards_dir={out / 'shards'}",
        # utterances of 4800-7200 samples pad to 6400 or 9600, so batches differ in rows and
        # in T; the JAX run compiles a program per shape, so there are few of them
        "data.dataloader.train_max_num_samples=16000", "data.dataloader.queue_size=8",
        "data.dataloader.pad_to_multiple=3200", "data.dataloader.eval_batch_size=3",
        "trainer.max_steps=4", "trainer.val_check_interval=2", "trainer.num_sanity_val_steps=1",
        "trainer.save_top_k=2", "callbacks=default_speech", f"trainer.checkpoint_dir={out / 'ckpt'}", "seed=4",
        *extra,
    ]


def speaker_overrides(corpus, out: pathlib.Path, *extra):
    wav_dir, trials = corpus
    return [
        "+experiment=speaker_wav2vec2_ctc", *TINY, f"data.module.data_dir={wav_dir}",
        f"data.module.shards_dir={out / 'shards'}", f"data.module.test_trial_path={trials}",
        "data.module.train_val_ratio=0.7", "data.module.eer_validation_pairs=10", "data.shards.samples_per_shard=8",
        "data.dataloader.batch_size=8", "data.dataloader.test_batch_size=4", "data.dataloader.test_pad_to_multiple=4800",
        "data.pipeline.chunk_length_sec=0.15", "trainer.max_steps=4", "trainer.limit_train_batches=2",
        "trainer.max_epochs=1", "trainer.val_check_interval=2",
        "trainer.num_sanity_val_steps=0", f"trainer.checkpoint_dir={out / 'ckpt'}", "seed=5", *extra,
    ]


def _export(task, example, tmp: pathlib.Path) -> None:
    from w2v2_speaker_tpu.train.checkpoint import save_params

    params, _ = task.init(jax.random.PRNGKey(7), example)
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])


def _run_both(make_argv, tmp):
    import run as jrun

    objectives = {}
    for name, init in (("jax", tmp / "init"), ("torch", tmp / "init.npz")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            argv = make_argv(tmp / name, f"load_network_from_checkpoint={init}")
            objectives[name] = jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu")
        sys.stdout.write(out.getvalue())
    return objectives


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' speech runs and speaker-CTC runs: the recorded steps,
    evaluations and logged texts, the objectives, the run dirs."""
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config

    tmp = tmp_path_factory.mktemp("torch_run_speech")
    dirs = write_librispeech(tmp / "raw")
    speaker_tmp = tmp / "speaker"
    corpus = write_voxceleb(speaker_tmp)
    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    texts = {"jax": [], "torch": []}
    for name, mod in (("jax", jlogging), ("torch", tlogging)):
        def log_text(self_, step, tag, text, name=name, orig=mod.MetricsLogger.log_text):
            texts[name].append((step, tag, text))
            return orig(self_, step, tag, text)
        monkeypatch.setattr(mod.MetricsLogger, "log_text", log_text)
    try:
        cfg = jax_load_config(ROOT / "config", "train_eval", speech_overrides(dirs, tmp / "jax"))
        dm = jexp.build_data_module(cfg)  # the JAX run reuses these shards
        task, _ = jexp.build_model_and_task(cfg, 0, tokenizer=dm.tokenizer)
        _export(task, {"features": jnp.zeros((2, SR // 4)), "mask": jnp.ones((2, SR // 4), bool)}, tmp)
        speech = _run_both(lambda out, init: speech_overrides(dirs, out, init), tmp)
        cfg = jax_load_config(ROOT / "config", "train_eval", speaker_overrides(corpus, speaker_tmp))
        task, _ = jexp.build_model_and_task(cfg, 5)  # 8 speakers, 3 of them test
        _export(task, {"features": jnp.zeros((2, SR // 10))}, speaker_tmp)
        n_speech = {k: len(v) for k, v in rec.steps.items()}
        speaker = _run_both(lambda out, init: speaker_overrides(corpus, out, init), speaker_tmp)
    finally:
        monkeypatch.undo()
    return rec, texts, n_speech, speech, speaker, tmp


def test_speech_run_matches_jax_run(runs):
    """Steps 1-4 (token-budget batches of varying shape, across an epoch):
    the same CTC losses; the sanity, interval and test evaluations equal;
    the objective is the test-clean WER."""
    rec, _, n_speech, objectives, _, _ = runs
    torch_steps, jax_steps = (rec.steps[n][: n_speech[n]] for n in ("torch", "jax"))
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == [1, 2, 3, 4]
    got, want = [v for _, v in torch_steps], [v for _, v in jax_steps]
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert all(np.isfinite(v) and v > 0 for _, v in torch_steps)
    evals = {n: [e for e in rec.evals[n] if any("wer" in k for k in e[1])] for n in ("torch", "jax")}
    assert evals["torch"] == evals["jax"]
    steps, metrics = zip(*evals["torch"])
    best = json.loads((runs[-1] / "torch" / "ckpt" / "index.json").read_text())["best"][0]["step"]
    assert steps == (0, 2, 4, best)  # sanity, validations, the test at the best step
    assert sorted(metrics[1]) == ["val_wer", "val_wer_clean", "val_wer_other"]
    assert sorted(metrics[-1]) == ["test_clean_wer", "test_other_wer"]
    assert objectives["torch"] == objectives["jax"] == metrics[-1]["test_clean_wer"] >= 0


def test_tracked_transcription_matches_jax(runs):
    """The first training utterance's ground truth at step 0, then the
    model's transcription of it at the sanity and every validation."""
    _, texts, _, _, _, _ = runs
    speech = {n: [t for t in texts[n] if t[1].startswith("train/tracked")] for n in ("torch", "jax")}
    assert speech["torch"] == speech["jax"]
    assert [(s, tag) for s, tag, _ in speech["torch"]] == [
        (0, "train/tracked_ground_truth"), *((s, "train/tracked_transcription") for s in (0, 2, 4))]


def test_speech_checkpoints_rank_by_val_wer(runs):
    _, _, _, _, _, tmp = runs
    names = {n: sorted(p.name for p in (tmp / n / "ckpt").iterdir()) for n in ("jax", "torch")}
    assert names["torch"] == names["jax"]
    index = json.loads((tmp / "torch" / "ckpt" / "index.json").read_text())
    assert [e["name"] for e in index["best"]] == [e["name"] for e in json.loads(
        (tmp / "jax" / "ckpt" / "index.json").read_text())["best"]]
    assert len(index["best"]) == 2 and all("_val_wer=" in e["name"] for e in index["best"])
    assert [e["metric"] for e in index["best"]] == sorted(e["metric"] for e in index["best"])
    assert index["last"]["step"] == 4


def test_speaker_ctc_run_matches_jax_run(runs):
    """Two frame-level CTC steps in one dispatch: the same losses (finite
    from the blank bias of 100), the validation and test EER equal."""
    rec, _, n_speech, _, objectives, _ = runs
    torch_steps, jax_steps = (rec.steps[n][n_speech[n]:] for n in ("torch", "jax"))
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == [1, 2]
    np.testing.assert_allclose([v for _, v in torch_steps], [v for _, v in jax_steps], rtol=FIRST_RTOL)
    assert all(np.isfinite(v) for _, v in torch_steps)
    evals = {n: [m for _, m in rec.evals[n] if "val_eer" in m or "test_eer" in m] for n in ("torch", "jax")}
    assert len(evals["torch"]) == len(evals["jax"]) == 2
    for got, want in zip(evals["torch"], evals["jax"]):
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=0, abs=1e-5 if k.endswith("threshold") else 0), k
    assert objectives["torch"] == objectives["jax"] == evals["torch"][-1]["test_eer"]
    assert 0 <= objectives["torch"] <= 1


def test_speech_run_refuses_steps_per_dispatch(runs, tmp_path):
    _, _, _, _, _, tmp = runs
    dirs = {key: tmp / "raw" / split for split, key, _ in SPLITS}
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        trun.main(speech_overrides(dirs, tmp_path, f"data.module.shards_dir={tmp / 'torch' / 'shards'}",
                                   "+trainer.steps_per_dispatch=2"), device="cpu")


def test_ctc_recipes_need_a_card_unless_asked_for_the_cpu(runs, tmp_path):
    """Without ``device="cpu"`` the run twin goes to the card, and on a
    host without one it raises before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, _, _, _, tmp = runs
    dirs = {key: tmp / "raw" / split for split, key, _ in SPLITS}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(speech_overrides(dirs, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(speaker_overrides(write_voxceleb(tmp_path / "vox"), tmp_path))
    assert not (tmp_path / "shards").exists()


def test_speech_lr_range_test_runs(runs, tmp_path):
    """``run_lr_range_test`` on the speech recipe: the LibriSpeech data
    module has no augmenter, so drawing the example batch must not ask it
    for one; the suggestion comes back and ``data.json`` holds the rates."""
    _, _, _, _, _, tmp = runs
    dirs = {key: tmp / "raw" / split for split, key, _ in SPLITS}
    argv = speech_overrides(dirs, tmp_path, f"data.module.shards_dir={tmp / 'torch' / 'shards'}",
                            "run_lr_range_test=true", "tune_iterations=3")
    suggestion = trun.main(argv, device="cpu")
    data = json.loads((tmp_path / "auto_lr_find" / "data.json").read_text())
    assert suggestion == data["suggestion"] and 1 <= len(data["lr"]) == len(data["loss"]) <= 3
