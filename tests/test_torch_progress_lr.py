"""The LR range test, the progress tracker and the reduce-on-plateau loop
of the port against the JAX package's on the CPU:

- ``runtime/lr_find.py::lr_range_test`` on a small x-vector (TDNN 16 x 4 +
  32, 40 mels, no dropout) from the same weights (``params_from_jax``)
  over the same batches, one of another shape (skipped without a step in
  both): the rates equal (float64 in ``data.json``, the float32 table in
  the optimizer), the smoothed losses within 1e-5 relative, the suggestion
  equal, ``data.json`` and the plot written;
- ``runtime/progress.py::ProgressTracker`` on the same batches: the probe
  set picked (features, mask, labels) equal, a snapshot's
  ``embeddings.npy`` and ``stats.txt`` equal and its separation metrics
  within 1e-12, for the same embedding function;
- both packages' ``run.main`` on the small ``speaker_xvector`` of
  ``tests/test_torch_run_families.py`` with
  ``callbacks=speaker_progress_tracker`` and ``reduce_on_plateau``
  (patience 0), 6 steps with a validation every 2: per-step losses within
  1e-5, the same ``plateau:`` lines, a snapshot at each validation whose
  embeddings agree within 1e-5 (float32, the same math in other summation
  orders; read ~1e-7) and whose separation metrics, logged beside
  ``val_eer``, agree within 1e-5. The runs train at lr 1e-6: the
  embedding layer's bias has gradients near 0 (the classifier's training
  BatchNorm nearly cancels a shift of the embedding), and Adam turns the
  float32 rounding of their signs into whole steps of the rate (ROADMAP
  Queue 3), which at lr 1e-3 moves every embedding by a shared ~3.7e-3
  while the losses still agree. Before this port the run twin trained
  this network with the callback dropped; the JAX package snapshots every
  speaker-family network (``runtime/experiment.py:1480-1500``).
"""

import contextlib
import io
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import Recorder, write_corpus, one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from test_torch_run_families import _export, run_overrides
from w2v2_speaker_tpu.data.features import FbankConfig as JaxFbankConfig
from w2v2_speaker_tpu.models import xvector as jxv
from w2v2_speaker_tpu.models.frontend import FbankFrontend as JaxFrontend
from w2v2_speaker_tpu.parallel.mesh import create_mesh
from w2v2_speaker_tpu.runtime import lr_find as jlr
from w2v2_speaker_tpu.runtime import progress as jprogress
from w2v2_speaker_tpu.train.speaker_task import SpeakerTask as JaxSpeakerTask
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data.features import FbankConfig
from w2v2_speaker_tpu_torch.models import xvector as txv
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.models.frontend import FbankFrontend
from w2v2_speaker_tpu_torch.runtime import lr_find as tlr
from w2v2_speaker_tpu_torch.runtime import progress as tprogress
from w2v2_speaker_tpu_torch.train.speaker_task import SpeakerTask

SPEAKERS = 5
XV = dict(tdnn_channels=(16, 16, 16, 16, 32), lin_neurons=16)
LOSS_RTOL = 1e-5
RUN_ATOL = 1e-5
PLATEAU = ["callbacks=speaker_progress_tracker", "optim/schedule=reduce_on_plateau", "optim.schedule.patience=0",
           "trainer.max_steps=6", "optim.algo.lr=1e-6"]


def _batches(n=5, rows=4, samples=8000, seed=0):
    """``n`` padded batches of tones and noise with labels 0-4; the third is
    of another length."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t_len = samples + (800 if i == 2 else 0)
        lengths = rng.integers(t_len // 2, t_len + 1, rows)
        lengths[0] = t_len
        t = np.arange(t_len) / 16000
        wav = rng.normal(0, 0.3, (rows, t_len)) + np.sin(2 * np.pi * rng.uniform(100, 3000, (rows, 1)) * t)
        mask = np.arange(t_len)[None, :] < lengths[:, None]
        out.append({"features": (wav * mask).astype(np.float32), "mask": mask,
                    "labels": rng.integers(0, SPEAKERS, rows).astype(np.int32)})
    return out


def _models():
    cfg = jxv.XVectorConfig(in_channels=40, **XV)
    jmodel = JaxFrontend(jxv.XVectorModel(cfg, SPEAKERS), fbank=JaxFbankConfig(n_mels=40))
    tmodel = FbankFrontend(txv.XVectorModel(txv.XVectorConfig(in_channels=40, **XV), SPEAKERS), FbankConfig(n_mels=40))
    b = _batches(1)[0]
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(b["features"]),
                                              jnp.asarray(b["mask"])))
    tmodel.load_state_dict(params_from_jax(v["params"], None, v.get("batch_stats")), strict=True)
    return jmodel, tmodel, v


def test_lr_range_test_matches_jax(tmp_path):
    jmodel, tmodel, v = _models()
    batches = _batches()
    want = jlr.lr_range_test(JaxSpeakerTask(model=jmodel, mode="ce"), v["params"],
                             {"batch_stats": v["batch_stats"]}, batches, create_mesh(jax.devices()[:1]),
                             min_lr=1e-6, max_lr=1e-1, num_steps=12, output_dir=tmp_path / "jax")
    got = tlr.lr_range_test(SpeakerTask(tmodel, "ce"), batches, torch.device("cpu"), min_lr=1e-6, max_lr=1e-1,
                            num_steps=12, output_dir=tmp_path / "torch")
    assert got["lr"] == want["lr"] and len(got["lr"]) == len(got["loss"]) >= 8  # the odd batch took no step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=0)
    assert got["suggestion"] == want["suggestion"] and got["suggestion"] in got["lr"]
    assert json.loads((tmp_path / "torch" / "data.json").read_text()) == got
    assert (tmp_path / "torch" / "plot.png").exists() == (tmp_path / "jax" / "plot.png").exists()


def test_lr_range_test_steps_at_the_float32_table(monkeypatch):
    """The rate of each step is the float32 table's entry (the JSON holds
    the float64 rates)."""
    _, tmodel, _ = _models()
    seen = []
    adam_step = torch.optim.Adam.step

    def step(self, *a, **kw):
        seen.append(self.param_groups[0]["lr"])
        return adam_step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    got = tlr.lr_range_test(SpeakerTask(tmodel, "ce"), _batches(), torch.device("cpu"), num_steps=6)
    table = np.exp(np.linspace(np.log(1e-8), np.log(1.0), 6))
    assert seen == [float(np.float32(x)) for x in table[: len(seen)]] and len(seen) == len(got["loss"])
    assert got["lr"] == table[: len(seen)].tolist()


def test_progress_tracker_matches_jax(tmp_path):
    batches = _batches(n=6, rows=4, seed=3)
    trackers = {"torch": tprogress.ProgressTracker(tmp_path / "torch", num_speakers=3, per_speaker=2),
                "jax": jprogress.ProgressTracker(tmp_path / "jax", num_speakers=3, per_speaker=2)}
    assert all(t.select_samples(batches) for t in trackers.values())
    got, want = trackers["torch"], trackers["jax"]
    for attr in ("features", "mask", "labels"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert got.features.shape[1] == 8800 and sorted(set(got.labels)) == [0, 1, 2]  # padded to the longest probe
    proj = np.random.default_rng(0).normal(size=(got.features.shape[1], 12)).astype(np.float32)

    def embed(features, mask):
        return (features * mask) @ proj

    m_got, m_want = got.snapshot(7, embed), want.snapshot(7, embed)
    assert set(m_got) == set(m_want) == {"track_intra_cos", "track_inter_cos", "track_separation"}
    for k in m_got:
        assert m_got[k] == pytest.approx(m_want[k], rel=0, abs=1e-12)
    for name in ("embeddings.npy", "stats.txt", "embeddings.png"):
        g, w = tmp_path / "torch" / "step_00000007" / name, tmp_path / "jax" / "step_00000007" / name
        assert g.exists() == w.exists()
        if name != "embeddings.png":
            assert g.read_bytes() == w.read_bytes(), name
    none = tprogress.ProgressTracker(tmp_path / "none", num_speakers=0)
    assert not none.select_samples(batches)
    capped = tprogress.ProgressTracker(tmp_path / "capped", num_speakers=5, per_speaker=9, max_scan_batches=1)
    assert capped.select_samples(batches) and len(capped.labels) == 4


@pytest.fixture(scope="module")
def tracked_runs(tmp_path_factory):
    """Both packages' x-vector runs with the tracker and the plateau
    schedule: (recorder, objectives, printed output, run dirs)."""
    import run as jrun

    tmp = tmp_path_factory.mktemp("tracked_run")
    corpus = write_corpus(tmp)
    ckpt, npz = _export("train_eval", run_overrides(corpus, tmp, "none"), tmp,
                        {"features": jnp.zeros((2, 16000)), "mask": jnp.ones((2, 16000), bool)}, 5)
    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    objectives, printed = {}, {}
    try:
        for name, init in (("jax", ckpt), ("torch", npz)):
            argv = [*run_overrides(corpus, tmp / name, init), *PLATEAU]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                objectives[name] = jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu")
            printed[name] = out.getvalue()
            sys.stdout.write(printed[name])
    finally:
        monkeypatch.undo()
    return rec, objectives, printed, tmp


def test_tracked_plateau_run_matches_jax(tracked_runs):
    rec, objectives, printed, tmp = tracked_runs
    jax_steps, torch_steps = rec.steps["jax"], rec.steps["torch"]
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == list(range(1, 7))
    np.testing.assert_allclose([v for _, v in torch_steps], [v for _, v in jax_steps], rtol=0, atol=RUN_ATOL)
    plateau = {n: [line for line in p.splitlines() if line.startswith("plateau:")] for n, p in printed.items()}
    assert plateau["torch"] == plateau["jax"] and plateau["torch"]  # the factor moved at a validation
    vals = {n: [(s, m) for s, m in rec.evals[n] if "val_eer" in m] for n in ("jax", "torch")}
    assert [s for s, _ in vals["torch"]] == [s for s, _ in vals["jax"]] == [2, 4, 6]
    for (_, got), (_, want) in zip(vals["torch"], vals["jax"], strict=True):
        assert sorted(got) == sorted(want) and "track_separation" in got
        for k, v in got.items():
            assert v == pytest.approx(want[k], rel=0, abs=RUN_ATOL), k
    for step in (2, 4, 6):
        g, w = (np.load(tmp / n / "progress" / f"step_{step:08d}" / "embeddings.npy") for n in ("torch", "jax"))
        assert g.shape == w.shape == (10, 16)
        np.testing.assert_allclose(g, w, rtol=0, atol=RUN_ATOL)
    assert objectives["torch"] == objectives["jax"]
