"""The run twin on ``+experiment=multitask_wav2vec2`` end to end on the CPU
against the JAX package's ``run.main``, both from the same parameters (the
JAX model's, saved with ``save_params`` and exported with
``tools/export_jax_params.py``), tiny networks in float32 with dropout,
layerdrop and masking at 0, on a LibriSpeech-layout tree the test writes:
9 training utterances over 3 speakers in two bucket lengths (6400 and 9600
samples), and validation and test splits of 6 utterances of one bucket over
2 speakers (3 each), so that ``num_val_pairs=6`` speaker trials can be
drawn there. ``ctc_ce``: 4 steps, a sanity validation and validations
every 2 (WER of both validation splits, the trials' EER), best-k by
``val_eer``, then both test WERs and the test EER; ``ctc_aam``: 2 steps of
a 4-step schedule, a validation and the test.

Both runs set ``trainer.num_devices=1``: on the tests' 8-device CPU mesh the
JAX package pads a token-budget batch's rows to 8 with empty rows of zero
audio, whose zero AAM embeddings give NaN gradients (the norm's at 0) that
the rows' zero weights do not stop, so its ``ctc_aam`` run reads NaN from
step 2 (ROADMAP Queue 3; pinned by ``test_torch_multitask.py``). The port,
on one card, pads nothing.

Limits, as ``test_torch_run_speech.py``'s for float32 CTC through Adam:
the first step's loss rel 1e-6, the later ones rel 1e-4; WERs, EERs and
minDCFs exact, their thresholds 1e-5."""

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
from test_torch_run import Recorder, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)

from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data.io import write_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
FIRST_RTOL, LOSS_RTOL = 1e-6, 1e-4
SPLITS = (("train", "train_dir", 9, 3), ("val_clean", "val_clean_dir", 6, 2), ("val_other", "val_other_dir", 6, 2),
          ("test_clean", "test_clean_dir", 6, 2), ("test_other", "test_other_dir", 6, 2))


def write_librispeech(root: pathlib.Path) -> dict:
    """Per split ``n`` utterances over ``speakers`` speakers (a speaker's
    tone under noise; 0.3-0.45 s in training, 0.3-0.38 s elsewhere),
    transcripts of 1-3 words of a small lexicon."""
    rng = np.random.default_rng(10)
    lexicon = ["A", "BE", "CAB", "DEAD", "ABBA", "ACE"]
    dirs = {}
    for i, (split, key, n, speakers) in enumerate(SPLITS):
        for u in range(n):
            spk, chap = 20 + 3 * i + u % speakers, 400
            d = root / split / f"{spk}" / f"{chap}"
            d.mkdir(parents=True, exist_ok=True)
            utt = f"{spk}-{chap}-{u:04d}"
            t = np.arange(int(SR * rng.uniform(0.3, 0.45 if split == "train" else 0.38))) / SR
            write_wav(d / f"{utt}.wav", (0.3 * np.sin(2 * np.pi * (300 + 150 * (spk % 5)) * t)
                                         + rng.normal(0, 0.2, t.shape)).astype(np.float32), SR)
            with open(d / f"{spk}-{chap}.trans.txt", "a") as f:
                f.write(f"{utt} {' '.join(rng.choice(lexicon, rng.integers(1, 4)))}\n")
        dirs[key] = root / split
    return dirs


def overrides(dirs, out: pathlib.Path, *extra):
    return [
        "+experiment=multitask_wav2vec2", "network.wav2vec2_size=tiny", "network.layerdrop=0.0",
        "network.hidden_dropout=0.0", "network.attention_dropout=0.0", "network.feat_proj_dropout=0.0",
        "network.mask_time_prob=0.0", "network.head_dropout=0.0", "trainer.precision=f32",
        *(f"data.module.{k}={v}" for k, v in dirs.items()), f"data.module.shards_dir={out / 'shards'}",
        "data.module.num_val_pairs=6", "data.dataloader.train_max_num_samples=16000",
        "data.dataloader.queue_size=8", "data.dataloader.pad_to_multiple=3200", "data.dataloader.eval_batch_size=6",
        "trainer.num_devices=1", "trainer.log_every=1", "trainer.log_dir=null",
        f"trainer.checkpoint_dir={out / 'ckpt'}", "seed=4", *extra,
    ]


CE = ["trainer.max_steps=4", "trainer.val_check_interval=2", "trainer.num_sanity_val_steps=1", "trainer.save_top_k=2"]
# 2 steps of a 4-step schedule: the JAX package's tri-stage rate is NaN when a
# stage rounds to 0 steps (as its one-cycle below 1 / pct_start steps)
AAM = ["optim/loss=ctc_aam", "trainer.max_steps=4", "trainer.limit_train_batches=2", "trainer.max_epochs=1",
       "trainer.num_sanity_val_steps=0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``ctc_ce`` and ``ctc_aam`` runs: the recorded steps
    and evaluations per run, the objectives, the run dirs."""
    import run as jrun
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.train.checkpoint import save_params

    tmp = tmp_path_factory.mktemp("torch_run_multitask")
    dirs = write_librispeech(tmp / "raw")
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    results = {}
    try:
        for loss, extra in (("ctc_ce", CE), ("ctc_aam", AAM)):
            out = tmp / loss
            cfg = jax_load_config(ROOT / "config", "train_eval", overrides(dirs, out / "jax", *extra))
            dm = jexp.build_data_module(cfg)
            task, kind = jexp.build_model_and_task(cfg, dm.num_speakers, tokenizer=dm.tokenizer)
            assert kind == "multitask"
            params, _ = task.init(jax.random.PRNGKey(7), {"features": jnp.zeros((2, SR // 4)),
                                                          "mask": jnp.ones((2, SR // 4), bool)})
            save_params(out / "init", params)
            export.main([str(out / "init"), str(out / "init.npz")])
            marks = {n: (len(rec.steps[n]), len(rec.evals[n])) for n in ("jax", "torch")}
            objectives = {}
            for name, init in (("jax", out / "init"), ("torch", out / "init.npz")):
                argv = overrides(dirs, out / name, *extra, f"load_network_from_checkpoint={init}")
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    objectives[name] = jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu")
                sys.stdout.write(printed.getvalue())
            results[loss] = ({n: rec.steps[n][marks[n][0]:] for n in marks},
                             {n: rec.evals[n][marks[n][1]:] for n in marks}, objectives, out)
    finally:
        monkeypatch.undo()
    return results


def _same_evals(evals):
    assert len(evals["torch"]) == len(evals["jax"]) > 0
    for (gs, got), (ws, want) in zip(evals["torch"], evals["jax"]):
        assert gs == ws and sorted(got) == sorted(want)
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=0, abs=1e-5 if k.endswith("threshold") else 0), k


@pytest.mark.parametrize("loss, n_steps", [("ctc_ce", 4), ("ctc_aam", 2)])
def test_multitask_run_matches_jax_run(runs, loss, n_steps):
    """The same losses (CTC + CE or AAM over token-budget batches of two
    shapes), the same validation and test metrics, and the test EER as the
    objective."""
    steps, evals, objectives, _ = runs[loss]
    assert [s for s, _ in steps["torch"]] == [s for s, _ in steps["jax"]] == list(range(1, n_steps + 1))
    got, want = [v for _, v in steps["torch"]], [v for _, v in steps["jax"]]
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert all(np.isfinite(v) and v > 0 for v in got)
    _same_evals(evals)
    test = evals["torch"][-1][1]
    assert sorted(test) == ["test_clean_wer", "test_eer", "test_mdc", "test_other_wer"]
    assert objectives["torch"] == objectives["jax"] == test["test_eer"] and 0 <= test["test_eer"] <= 1


def test_multitask_validations_and_checkpoints_match_jax(runs):
    """Sanity and interval validations carry both validation WERs and the
    trials' EER; the best-k checkpoints are ranked by ``val_eer``, as the
    JAX package ranks every kind but speech."""
    _, evals, _, out = runs["ctc_ce"]
    steps = [s for s, m in evals["torch"] if "sanity_val_eer" in m or "val_eer" in m]
    assert steps == [0, 2, 4]
    assert sorted(evals["torch"][1][1]) == ["val_eer", "val_mdc", "val_wer", "val_wer_clean", "val_wer_other"]
    names = {n: sorted(p.name for p in (out / n / "ckpt").iterdir()) for n in ("jax", "torch")}
    assert names["torch"] == names["jax"]
    index = json.loads((out / "torch" / "ckpt" / "index.json").read_text())
    assert len(index["best"]) == 2 and all("_val_eer=" in e["name"] for e in index["best"])
    assert [e["metric"] for e in index["best"]] == sorted(e["metric"] for e in index["best"])
    assert index["last"]["step"] == 4


def test_multitask_run_refuses_steps_per_dispatch(runs, tmp_path):
    _, _, _, out = runs["ctc_ce"]
    dirs = {key: out.parent / "raw" / split for split, key, _, _ in SPLITS}
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        trun.main(overrides(dirs, tmp_path, *CE, f"data.module.shards_dir={out / 'torch' / 'shards'}",
                            "+trainer.steps_per_dispatch=2"), device="cpu")
