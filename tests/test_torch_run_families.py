"""The run and predict twins on the networks off the wav2vec2 backbone,
against the JAX package's ``run.main`` and ``predict.main`` on the CPU,
from the same weights (the JAX package's, saved with ``save_params`` and
exported with ``tools/export_jax_params.py``):

- ``+experiment=speaker_xvector`` at small width (TDNN 16 x 4 + 32,
  16-d, 40 mels) on ``test_torch_run.write_corpus``'s WAV corpus: 4 steps
  in dispatches of 2 (the recipe's ``steps_per_dispatch`` cut to the run),
  a validation after each dispatch, the test. Per-step losses within 1e-5
  (read ~1e-7: float32, the same math in other summation orders, with
  the running statistics carried from step to step and dispatch to
  dispatch), the validation and test EERs equal, their thresholds within
  1e-5;
- ``predict.main`` with ``network=ecapa_tdnn`` at small width (channels
  32 x 4 + 96, AAM head) over 5 WAV files: the scores within 1e-5
  (``test_torch_predict.SCORE_ATOL``), the same pair order.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_predict import SCORE_ATOL, _scores, _write_folder
from test_torch_run import Recorder, write_corpus, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu_torch import predict as tpredict
from w2v2_speaker_tpu_torch import run as trun

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-5
XVECTOR = ["+experiment=speaker_xvector", "network.tdnn_channels=[16,16,16,16,32]", "network.lin_neurons=16",
           "trainer.steps_per_dispatch=2"]
ECAPA = ["network=ecapa_tdnn", "network.channels=[32,32,32,32,96]", "network.res2net_scale=4",
         "network.se_channels=8", "network.attention_channels=16", "network.lin_neurons=16",
         "optim/loss=aam_softmax", "trainer.precision=f32", "data.dataloader.test_batch_size=2",
         "data.dataloader.test_pad_to_multiple=4000"]


def _export(cfg_name, overrides, tmp, example, speakers):
    """The JAX model of the composed config over ``speakers`` classes,
    initialised, saved with ``save_params`` and exported: (checkpoint dir,
    .npz)."""
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.runtime.experiment import build_model_and_task
    from w2v2_speaker_tpu.train.checkpoint import save_params

    cfg = jax_load_config(ROOT / "config", cfg_name, overrides)
    task, _ = build_model_and_task(cfg, speakers)
    params, _ = task.init(jax.random.PRNGKey(7), example)
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])
    return tmp / "init", tmp / "init.npz"


def run_overrides(corpus, out: pathlib.Path, init):
    wav_dir, trials = corpus
    return [
        *XVECTOR, f"data.module.data_dir={wav_dir}", f"data.module.shards_dir={out / 'shards'}",
        f"data.module.test_trial_path={trials}", "data.module.train_val_ratio=0.7",
        "data.module.eer_validation_pairs=10", "data.shards.samples_per_shard=8",
        "data.dataloader.batch_size=8", "data.dataloader.test_batch_size=4",
        "data.dataloader.test_pad_to_multiple=8000", "data.pipeline.chunk_length_sec=1.0",
        "trainer.max_steps=4", "trainer.val_check_interval=2", "trainer.num_sanity_val_steps=0",
        "trainer.log_every=1", "trainer.log_dir=null", f"trainer.checkpoint_dir={out / 'ckpt'}",
        "seed=3", f"load_network_from_checkpoint={init}",
    ]


@pytest.fixture(scope="module")
def xvector_runs(tmp_path_factory):
    """Both packages' x-vector runs: (recorded steps and evaluations,
    objectives)."""
    import run as jrun

    tmp = tmp_path_factory.mktemp("xvector_run")
    corpus = write_corpus(tmp)
    ckpt, npz = _export("train_eval", run_overrides(corpus, tmp, "none"), tmp,
                        {"features": jnp.zeros((2, 16000)), "mask": jnp.ones((2, 16000), bool)}, 5)
    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    try:
        objectives = {"jax": jrun.main(run_overrides(corpus, tmp / "jax", ckpt)),
                      "torch": trun.main(run_overrides(corpus, tmp / "torch", npz), device="cpu")}
    finally:
        monkeypatch.undo()
    return rec, objectives


def test_xvector_run_matches_jax_run(xvector_runs):
    rec, objectives = xvector_runs
    jax_steps, torch_steps = rec.steps["jax"], rec.steps["torch"]
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in torch_steps], [v for _, v in jax_steps], rtol=0, atol=LOSS_ATOL)
    assert len(set(v for _, v in torch_steps)) == 4  # the weights moved between steps
    for (s_got, got), (s_want, want) in zip(rec.evals["torch"], rec.evals["jax"], strict=True):
        assert s_got == s_want and sorted(got) == sorted(want)
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=0, abs=1e-5 if k.endswith("threshold") else 0), k
    assert [s for s, m in rec.evals["torch"] if "val_eer" in m] == [2, 4]
    assert objectives["torch"] == objectives["jax"] == rec.evals["torch"][-1][1]["test_eer"]
    assert 0 <= objectives["torch"] <= 1


def test_ecapa_predict_matches_jax_predict(tmp_path_factory):
    import predict as jax_predict

    tmp = tmp_path_factory.mktemp("ecapa_predict")
    ckpt, npz = _export("predict", ECAPA, tmp, {"features": jnp.zeros((2, 16000)),
                                                "mask": jnp.ones((2, 16000), bool)}, 2)
    runs = {}
    for name, init in (("jax", ckpt), ("torch", npz)):
        folder = tmp / name
        folder.mkdir()
        argv = [*ECAPA, f"predict_folder_path={folder}", f"pair_prediction_path={_write_folder(folder)}",
                f"load_network_from_checkpoint={init}"]
        runs[name] = _scores(jax_predict.main(argv) if name == "jax" else tpredict.main(argv, device="cpu"))
    (want, want_pairs), (got, got_pairs) = runs["jax"], runs["torch"]
    assert got_pairs == want_pairs and len(got) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert np.all((got >= 0) & (got <= 1)) and np.ptp(got) > 100 * SCORE_ATOL  # scores that differ
