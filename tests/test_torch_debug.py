"""The debug surface (``runtime/debug.py`` and its wiring in the run twin)
against the JAX package's on the CPU:

- ``run.main`` on a small ``speaker_xvector`` (test_torch_run_families'
  widths and corpus) with ``data/pipeline=xvector_dropout_augment_pipeline``
  and ``trainer.dump_first_batch=true`` in both packages, from the same
  weights: the same per-step losses (``LOSS_ATOL``), the same artifact
  tree under ``first_batch`` (the collated batch and the per-sample stages
  ``00_original``, ``01_augment_time_dropout``, ... ``normalize0``, each as
  ``.npy`` + ``.txt`` + ``.wav``) and equal arrays in it (the augmented
  samples are bit-identical);
- ``PipelineDebugCapture`` on both packages' VoxCeleb pipelines with
  ``max_samples`` 2 (the same tree) and 0 (nothing written), and on their
  LibriSpeech pipelines (``original``, ``transcription``, ``tokens``);
- ``verify_model`` passing on the x-vector and a BASE-tiny wav2vec2
  network (``model_summary``'s total equal to the JAX parameter count) and
  raising on a planted leak, a BatchNorm that normalises with the batch's
  statistics in eval;
- a planted failing training step: its batch dumped under
  ``debug_batch/train_step`` (keys included) and the error raised on.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_datamodule import CONFIG as DM_CONFIG
from test_torch_datamodule import write_corpus as write_dm_corpus
from test_torch_librispeech import CONFIG as LS_CONFIG
from test_torch_librispeech import write_tree
from test_torch_run import Recorder, write_corpus, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from test_torch_run_families import LOSS_ATOL, _export, run_overrides
from w2v2_speaker_tpu.data import datamodule as jdm
from w2v2_speaker_tpu.data import librispeech as jls
from w2v2_speaker_tpu.runtime import debug as jdebug
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data import datamodule as tdm
from w2v2_speaker_tpu_torch.data import librispeech as tls
from w2v2_speaker_tpu_torch.models import pooling as tpool
from w2v2_speaker_tpu_torch.models.wav2vec2 import init_parameters
from w2v2_speaker_tpu_torch.runtime import debug as tdebug
from w2v2_speaker_tpu_torch.runtime import experiment as texp

AUGMENTED = ["data/pipeline=xvector_dropout_augment_pipeline", "trainer.dump_first_batch=true"]


def tree(root: pathlib.Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def assert_same_arrays(got_root: pathlib.Path, want_root: pathlib.Path):
    files = tree(want_root)
    assert tree(got_root) == files and files
    for rel in files:
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got_root / rel), np.load(want_root / rel), err_msg=rel)
        elif rel.endswith(".txt") and "batch_keys" in rel:
            assert (got_root / rel).read_text() == (want_root / rel).read_text()


@pytest.fixture(scope="module")
def augmented_runs(tmp_path_factory):
    """Both packages' augmented x-vector runs with the first batch dumped:
    (recorder, run dirs)."""
    import run as jrun

    tmp = tmp_path_factory.mktemp("debug_runs")
    corpus = write_corpus(tmp)
    ckpt, npz = _export("train_eval", [AUGMENTED[0], *run_overrides(corpus, tmp, "none")], tmp,
                        {"features": jnp.zeros((2, 16000)), "mask": jnp.ones((2, 16000), bool)}, 5)
    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    try:
        jrun.main([AUGMENTED[0], *run_overrides(corpus, tmp / "jax", ckpt), *AUGMENTED[1:]])
        trun.main([AUGMENTED[0], *run_overrides(corpus, tmp / "torch", npz), *AUGMENTED[1:]], device="cpu")
    finally:
        monkeypatch.undo()
    return rec, {name: tmp / name for name in ("jax", "torch")}


def test_augmented_run_losses_match_jax(augmented_runs):
    rec, _ = augmented_runs
    jax_steps, torch_steps = rec.steps["jax"], rec.steps["torch"]
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in torch_steps], [v for _, v in jax_steps], rtol=0, atol=LOSS_ATOL)
    assert len(set(v for _, v in torch_steps)) == 4


def test_first_batch_artifact_tree_matches_jax(augmented_runs):
    _, dirs = augmented_runs
    got, want = dirs["torch"] / "first_batch", dirs["jax"] / "first_batch"
    assert_same_arrays(got, want)
    samples = sorted(p for p in (got / "per_sample").iterdir() if p.is_dir())
    assert len(samples) == 4  # callbacks.input_monitor.max_samples' default
    stages = [p.stem for p in sorted(samples[0].glob("*.npy"))]
    assert stages[:4] == ["00_original", "01_augment_time_dropout", "02_augment_frequency_dropout",
                          "03_augment_choice_speed"]
    assert {s.split("_", 1)[1] for s in stages[4:]} <= {f"{k}{i}" for k in ("chunk", "normalize") for i in range(4)}
    for d in samples:
        names = {p.name for p in d.iterdir()}
        assert all(f"{n[:-4]}.txt" in names and f"{n[:-4]}.wav" in names for n in names if n.endswith(".npy"))
    assert {"batch_features.npy", "batch_labels.npy", "batch_keys.txt"} <= {p.name for p in got.glob("batch_*")}


@pytest.mark.parametrize("max_samples", [2, 0])
def test_voxceleb_capture_matches_jax(tmp_path, max_samples):
    """One epoch of both packages' augmented pipelines, each with a
    capture; ``max_samples=0`` writes nothing."""
    wav_dir, trials = write_dm_corpus(tmp_path)
    p = texp.load_recipe("speaker_xvector", [AUGMENTED[0]])["data"]["pipeline"]
    for name, dm_mod, exp, dbg in (("jax", jdm, jexp, jdebug), ("torch", tdm, texp, tdebug)):
        cfg = dm_mod.VoxCelebConfig(data_dir=wav_dir, test_trial_path=trials, shards_dir=tmp_path / f"{name}_shards",
                                    **{**DM_CONFIG, "queue_size": 200}, chunk_strategy="contiguous",
                                    augmenter=exp.build_augmenter(p, 11))
        dm = dm_mod.VoxCelebDataModule(cfg)
        dm.prepare_data()
        dm.cfg.debug_capture = dbg.PipelineDebugCapture(tmp_path / name / "per_sample", max_samples=max_samples)
        list(dm.train_batches())
        list(dm.train_batches(epoch=1))  # a later pass over the same keys adds nothing
        list(dm.val_batches())
    if max_samples == 0:
        assert not (tmp_path / "torch").exists() and not (tmp_path / "jax").exists()
        return
    assert_same_arrays(tmp_path / "torch", tmp_path / "jax")
    assert len(list((tmp_path / "torch" / "per_sample").iterdir())) == 2


def test_librispeech_capture_matches_jax(tmp_path):
    splits = {"train": write_tree(tmp_path / "raw" / "train")}
    for name, mod, dbg in (("jax", jls, jdebug), ("torch", tls, tdebug)):
        dm = mod.LibriSpeechDataModule(mod.LibriSpeechConfig(split_dirs=splits, shards_dir=tmp_path / f"{name}_shards",
                                                             **LS_CONFIG))
        dm.prepare_data()
        dm.cfg.debug_capture = dbg.PipelineDebugCapture(tmp_path / name, max_samples=3)
        dm.vocabulary_consistency_check()  # reads every split without capturing
        list(dm.train_batches())
        list(dm.train_batches(epoch=1))
    files = tree(tmp_path / "torch")
    assert files == tree(tmp_path / "jax") and len({f.split("/")[0] for f in files}) == 3
    assert all(any(f.endswith(s) for f in files) for s in ("00_original.wav", "01_transcription.txt",
                                                           "02_tokens.npy"))
    assert not any(f.endswith("02_tokens.wav") for f in files)
    for rel in files:
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "torch" / rel), np.load(tmp_path / "jax" / rel))
        elif rel.endswith("transcription.txt"):
            assert (tmp_path / "torch" / rel).read_text() == (tmp_path / "jax" / rel).read_text()


def _example(rows=4, seed=5):
    """Another seed than the probe's own draws (0): a row replaced by the
    same noise at another scale is the same row after per-utterance
    normalisation."""
    rng = np.random.default_rng(seed)
    lengths = np.array([16000, 12000, 9000, 16000][:rows])
    mask = np.arange(16000)[None, :] < lengths[:, None]
    return {"features": (rng.normal(0, 0.3, mask.shape) * mask).astype(np.float32), "mask": mask,
            "labels": np.arange(rows, dtype=np.int32)}


SMALL = {"speaker_xvector": ["network.tdnn_channels=[16,16,16,16,32]", "network.lin_neurons=16"],
         "speaker_wav2vec2_ce": ["network.wav2vec2_size=tiny", "trainer.precision=f32"]}


def _task(recipe):
    cfg = texp.load_recipe(recipe, SMALL[recipe])
    task, _ = texp.build_model_and_task(cfg, 5)
    init_parameters(task.model, torch.Generator().manual_seed(0))
    return cfg, task


@pytest.mark.parametrize("recipe", sorted(SMALL))
def test_verify_model_passes_and_counts_as_jax(recipe, capsys):
    cfg, task = _task(recipe)
    texp.verify_model(task, _example(), torch.device("cpu"))
    out = capsys.readouterr().out
    assert "model parameters:" in out and "batch gradient verification: no cross-batch leakage" in out
    jtask, _ = jexp.build_model_and_task(cfg, 5)
    params = jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16000)))["params"]
    want_total = jdebug.model_summary(params).splitlines()[-1]
    assert tdebug.model_summary(task.model).splitlines()[-1] == want_total


@pytest.mark.parametrize("recipe", sorted(SMALL))
def test_verify_model_raises_on_a_batch_norm_in_train_mode(recipe, monkeypatch):
    """x-vector's BatchNorms on the batch's statistics in eval leak across
    rows; BASE-tiny has no BatchNorm, so its planted leak is a mean over
    the batch added to every row's features."""
    cfg, task = _task(recipe)
    if recipe == "speaker_xvector":
        real = tpool.BatchNorm.forward
        monkeypatch.setattr(tpool.BatchNorm, "forward", lambda self, x, train=False: real(self, x, True))
    else:
        real = task.model.compute_embedding
        monkeypatch.setattr(task.model, "compute_embedding",
                            lambda wav, mask=None: real(wav + wav.mean(dim=0, keepdim=True), mask))
    with pytest.raises(AssertionError, match="cross-batch leakage"):
        texp.verify_model(task, _example(), torch.device("cpu"))


def test_a_probe_that_moves_nothing_raises():
    with pytest.raises(AssertionError, match="vacuous"):
        tdebug.batch_gradient_verification(lambda f, m: np.zeros((f.shape[0], 3)), _example()["features"])


def test_failed_step_dumps_its_batch(tmp_path, monkeypatch, capsys):
    corpus = write_corpus(tmp_path)

    def failing(*args, **kwargs):
        def step(state, batch):
            raise RuntimeError("planted training-step failure")
        return step

    monkeypatch.setattr(texp, "make_train_step", failing)
    argv = [*run_overrides(corpus, tmp_path, "none")[:-1], "trainer.steps_per_dispatch=2"]  # no checkpoint
    with pytest.raises(RuntimeError, match="planted training-step failure"):
        trun.main(argv, device="cpu")
    dump = tmp_path / "debug_batch" / "train_step"
    assert "offending batch(es) dumped to" in capsys.readouterr().out
    assert sorted(p.name for p in dump.iterdir()) == ["chunk0", "chunk1"]
    names = {p.name for p in (dump / "chunk0").iterdir()}
    assert {"batch_features.npy", "batch_labels.npy", "batch_keys.txt"} <= names
    keys = eval((dump / "chunk1" / "batch_keys.txt").read_text())
    assert len(keys) == 8 and all(k.count("/") == 2 for k in keys)
