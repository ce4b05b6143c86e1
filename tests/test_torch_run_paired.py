"""The run twin on the paper's w2v2-bce recipe (``+experiment=speaker_wav2vec2_pairs``)
end to end on the CPU against the JAX package's ``run.main``: a tiny
paired network in float32 with dropout, layerdrop and masking at 0, both
packages started from the same parameters (saved with ``save_params``,
exported with ``tools/export_jax_params.py``), on a corpus of short
utterances the test writes (so that the packed pairs of the tiny
network's 10x-strided frames stay a few hundred tokens long). Shards in
runs of 4 samples per speaker, pair batches of 8 (4 positive, 4
negative), 4 steps with a validation every 2 and a sanity validation,
then the test pairs scored through the network.

The JAX package's ``_train_loop`` reads ``batch["features"]`` to drop
ragged batches, a key its paired batches lack, so its pairs recipe stops
at the first training batch with a ``KeyError``. Its run here gets
batches with ``features`` as an alias of ``features_a``, which its loss
never reads; nothing else of the reference changes.

Limits: per-step losses 1e-5 (float32, the same math in other summation
orders); validation and test EER and minDCF exactly, their thresholds and
every sigmoid score 1e-5."""

import contextlib
import importlib.util
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_run import Recorder, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)

from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data.io import write_wav
from w2v2_speaker_tpu_torch.runtime import experiment as texp

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
LOSS_ATOL, SCORE_ATOL = 1e-5, 1e-5
RECIPE = [
    "+experiment=speaker_wav2vec2_pairs", "network.wav2vec2_size=tiny", "network.layerdrop=0.0",
    "network.hidden_dropout=0.0", "network.attention_dropout=0.0", "network.feat_proj_dropout=0.0",
    "network.mask_time_prob=0.0", "trainer.precision=f32",
]


def write_corpus(root: pathlib.Path, n_spk=8, test_spk=3):
    """3 sessions x 3 utterances of 0.2-0.3 s per speaker (a speaker's
    three tones under loud noise) and a trial file over the last
    ``test_spk`` speakers; returns (wav root, trial file)."""
    rng = np.random.default_rng(1)
    wav_dir = root / "wav"
    for s in range(n_spk):
        freqs = rng.uniform(200, 3500, 3)
        for y in range(3):
            for u in range(3):
                t = np.arange(int(SR * rng.uniform(0.2, 0.3))) / SR
                sig = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) for f in freqs)
                path = wav_dir / f"id{s:05d}/yt{y}/{u:05d}.wav"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_wav(path, (0.1 * sig + rng.normal(0, 0.6, t.shape)).astype(np.float32), SR)
    test_ids = [f"id{s:05d}" for s in range(n_spk - test_spk, n_spk)]
    lines = []
    for i, spk in enumerate(test_ids):
        for y in range(3):
            lines.append(f"1 {spk}/yt{y}/00000.wav {spk}/yt{(y + 1) % 3}/00001.wav")
            lines.append(f"0 {spk}/yt{y}/00000.wav {test_ids[(i + 1) % test_spk]}/yt{y}/00002.wav")
    (root / "trials.txt").write_text("\n".join(lines) + "\n")
    return wav_dir, root / "trials.txt"


def overrides(corpus, out: pathlib.Path, *extra):
    wav_dir, trials = corpus
    return [
        *RECIPE, f"data.module.data_dir={wav_dir}", f"data.module.shards_dir={out / 'shards'}",
        f"data.module.test_trial_path={trials}", "data.module.train_val_ratio=0.7",
        "data.module.eer_validation_pairs=10", "data.shards.samples_per_shard=8",
        "data.dataloader.batch_size=8", "data.dataloader.test_pad_to_multiple=4800",
        "data.pipeline.chunk_length_sec=0.15", "trainer.max_steps=4", "trainer.val_check_interval=2",
        "trainer.num_sanity_val_steps=1", "trainer.log_every=1", "trainer.log_dir=null",
        f"trainer.checkpoint_dir={out / 'ckpt'}", "seed=3", *extra,
    ]


def _alias_features(collate):
    def collate_with_alias(samples, **kw):
        batch = collate(samples, **kw)
        batch["features"] = batch["features_a"]
        return batch
    return collate_with_alias


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs: the corpus, the recorded steps, evaluations and
    (labels, scores) of every scoring, the objectives, the run dirs."""
    import run as jrun
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.train.checkpoint import save_params

    tmp = tmp_path_factory.mktemp("torch_run_paired")
    corpus = write_corpus(tmp)
    task, _ = jexp.build_model_and_task(jax_load_config(ROOT / "config", "train_eval", overrides(corpus, tmp)), 5)
    z = jnp.zeros((2, SR // 10))
    params, _ = task.init(jax.random.PRNGKey(7), {"features_a": z, "features_b": z})
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])

    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    scored = {"jax": [], "torch": []}
    for name, mod in (("jax", jexp), ("torch", texp)):
        def metrics(gts, scores, name=name, orig=mod.paired_scores_to_metrics):
            scored[name].append((list(gts), list(scores)))
            return orig(gts, scores)
        monkeypatch.setattr(mod, "paired_scores_to_metrics", metrics)
    monkeypatch.setattr(jexp, "collate_paired_batch", _alias_features(jexp.collate_paired_batch))
    objectives = {}
    try:
        for name, init in (("jax", tmp / "init"), ("torch", tmp / "init.npz")):
            argv = overrides(corpus, tmp / name, f"load_network_from_checkpoint={init}")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                objectives[name] = jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu")
            sys.stdout.write(out.getvalue())
    finally:
        monkeypatch.undo()
    return corpus, rec, scored, objectives, tmp


def test_pairs_run_matches_jax_run(runs):
    """Steps 1-4: the same BCE losses; the sanity, interval and test
    evaluations (the test logged at the restored best checkpoint's step)
    and the objective equal."""
    _, rec, _, objectives, _ = runs
    jax_steps, torch_steps = rec.steps["jax"], rec.steps["torch"]
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in torch_steps], [v for _, v in jax_steps], rtol=0, atol=LOSS_ATOL)
    for (s_got, got), (s_want, want) in zip(rec.evals["torch"], rec.evals["jax"], strict=True):
        assert s_got == s_want and sorted(got) == sorted(want)
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=0, abs=SCORE_ATOL if k.endswith("threshold") else 0), k
    steps, evals = zip(*rec.evals["torch"])
    assert steps[:3] == (0, 2, 4) and len(steps) == 4
    assert {"sanity_val_eer", "val_eer", "val_mdc", "test_eer", "test_mdc"} <= {k for m in evals for k in m}
    assert objectives["torch"] == objectives["jax"] == evals[-1]["test_eer"]
    assert 0 < objectives["torch"] < 1


def test_pair_scores_match_jax(runs):
    """Every scoring (sanity, two validations, the test): the same labels
    in the same order, the sigmoid scores within 1e-5; the test scores all
    18 trials, one pair batch of 8 in the trial file's order after another."""
    _, _, scored, _, _ = runs
    assert len(scored["torch"]) == len(scored["jax"]) == 4
    for (gts, scores), (want_gts, want_scores) in zip(scored["torch"], scored["jax"]):
        assert gts == want_gts and len(scores) == len(gts) > 0
        np.testing.assert_allclose(scores, want_scores, rtol=0, atol=SCORE_ATOL)
    assert len(scored["torch"][-1][0]) == 18 and all(0 < s < 1 for s in scored["torch"][-1][1])


def test_pairs_checkpoints_match_jax(runs):
    """Best-k and last checkpoints under the same names as the JAX run's."""
    _, _, _, _, tmp = runs
    names = {name: sorted(p.name for p in (tmp / name / "ckpt").iterdir()) for name in ("jax", "torch")}
    assert names["torch"] == names["jax"] and "last" in names["torch"] and "index.json" in names["torch"]
    assert (tmp / "torch" / "ckpt" / "last" / "state.pt").exists()


def test_pairs_progress_tracker_is_ignored(runs, tmp_path, capsys):
    """A progress tracker is not supported for the paired family: the run
    says so and goes on, as the JAX package's does."""
    corpus, _, _, _, tmp = runs
    argv = overrides(corpus, tmp_path, "callbacks=speaker_progress_tracker", "fit_model=false", "eval_model=false",
                     f"data.module.shards_dir={tmp / 'torch' / 'shards'}")
    assert trun.main(argv, device="cpu") is None
    assert "progress tracker: unsupported for the paired task family; callback ignored" in capsys.readouterr().out
