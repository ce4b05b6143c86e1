"""The ``run.py`` twin (``python -m w2v2_speaker_tpu_torch.run``) end to end
on the CPU against the JAX package's ``run.main``, on a WAV corpus the test
writes: the same shards, batches and validation pairs, a tiny wav2vec2 CE
recipe in float32 with dropout, layerdrop and masking at 0, both packages
started from the same parameters (the JAX package's, saved with
``save_params`` and exported to ``.npz`` with ``tools/export_jax_params.py``).

Limits: per-step losses within 1e-5 (float32, the same math in other
summation orders: the readings are ~1e-6); validation and test EERs equal
and their thresholds within 1e-5 (the scores differ by ~1e-7, and no
pair of scores of this corpus lies that close to a threshold). Also ``fit_model`` / ``eval_model``,
resume, early stopping's decisions, the int8 eval-only run and
``trainer.num_devices=2`` on the port (two spawned gloo ranks against the
fixture's JAX 2-device run and 1-rank port run of the same first leg), and
more ranks than cards raising before any data is read. The fixture's JAX
runs take ``trainer.num_devices=2``; the port's runs use one intra-op
thread. The port-only runs on the same corpus (early stopping, the knobs)
are ``tests/test_torch_run_surface.py`` and the run surface (``-m``,
``+search``, SLURM, ``-sc``) ``tests/test_torch_run_search.py``: each file
on its own test worker. The helpers here (``write_corpus``, ``overrides``,
``Recorder``, ``package_runs``) are theirs too."""

import contextlib
import importlib.util
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.runtime import logging as jlogging
from w2v2_speaker_tpu.runtime.experiment import EarlyStopping as JaxEarlyStopping
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.data.io import write_wav
from w2v2_speaker_tpu_torch.device import DeviceError
from w2v2_speaker_tpu_torch.parallel import mesh as pmesh
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.runtime import logging as tlogging

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
LOSS_ATOL = 1e-5
RECIPE = [
    "+experiment=speaker_wav2vec2_ce", "network.wav2vec2_size=tiny", "network.layerdrop=0.0",
    "network.hidden_dropout=0.0", "network.attention_dropout=0.0", "network.feat_proj_dropout=0.0",
    "network.mask_time_prob=0.0", "trainer.precision=f32",
]


def write_corpus(root: pathlib.Path, n_spk=8, test_spk=3):
    """3 sessions x 3 utterances of 1.2-1.8 s per speaker (a speaker's
    three tones under loud noise, so the EERs are not 0) and a trial file
    over the last ``test_spk`` speakers; returns (wav root, trial file)."""
    rng = np.random.default_rng(0)
    wav_dir = root / "wav"
    for s in range(n_spk):
        freqs = rng.uniform(200, 3500, 3)
        for y in range(3):
            for u in range(3):
                t = np.arange(int(SR * rng.uniform(1.2, 1.8))) / SR
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
        f"data.module.data_dir={wav_dir}", f"data.module.shards_dir={out / 'shards'}",
        f"data.module.test_trial_path={trials}", "data.module.train_val_ratio=0.7",
        "data.module.eer_validation_pairs=10", "data.shards.samples_per_shard=8",
        "data.dataloader.batch_size=8", "data.dataloader.test_batch_size=4",
        "data.dataloader.test_pad_to_multiple=8000", "data.pipeline.chunk_length_sec=1.0",
        "trainer.max_steps=4", "trainer.val_check_interval=2", "trainer.num_sanity_val_steps=1",
        "trainer.log_every=1", "trainer.log_dir=null", f"trainer.checkpoint_dir={out / 'ckpt'}",
        "seed=3", *RECIPE, *extra,
    ]


class Recorder:
    """Every logged train step and evaluation of both packages' loggers."""

    def __init__(self, monkeypatch):
        self.steps, self.evals = {"jax": [], "torch": []}, {"jax": [], "torch": []}
        for name, mod in (("jax", jlogging), ("torch", tlogging)):
            log_step, log_eval = mod.MetricsLogger.log_step, mod.MetricsLogger.log_eval

            def step(self_, s, m, name=name, orig=log_step):
                self.steps[name].append((s, float(m["loss"])))
                return orig(self_, s, m)

            def evaluate(self_, s, m, split="val", name=name, orig=log_eval):
                self.evals[name].append((s, {k: v for k, v in m.items() if not k.endswith("seconds")}))
                return orig(self_, s, m, split)

            monkeypatch.setattr(mod.MetricsLogger, "log_step", step)
            monkeypatch.setattr(mod.MetricsLogger, "log_eval", evaluate)


# the fixture's first run: an interval validation every 3 steps, epochs of
# 2 batches (a validation at each epoch's end besides the interval ones,
# dispatches cut there), 2 epochs ending the run before max_steps, and the
# test on the average of the best 2 checkpoints
FIRST = ["trainer.max_steps=20", "trainer.val_check_interval=3", "trainer.limit_train_batches=2",
         "trainer.max_epochs=2", "trainer.save_top_k=2", "trainer.average_top_k=2"]
# resumed from step 4 to step 6 (an interval validation at 6) with the best
# single checkpoint
RESUMED = [*FIRST, "trainer.resume=true", "trainer.max_epochs=3", "trainer.max_steps=6",
           "trainer.average_top_k=1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: at these shapes eight threads buy nothing alone
    and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def package_runs(tmp: pathlib.Path, legs):
    """Both packages' runs of each leg's overrides in turn (``FIRST``, then
    ``RESUMED`` for the fixture here), from the JAX package's initial
    parameters (``save_params``, and for the port exported to ``.npz``),
    the JAX package's on 2 devices: the corpus, the recorded steps and
    evaluations, the objectives, each run's printed output, ``tmp``."""
    import run as jrun
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.runtime.experiment import build_model_and_task
    from w2v2_speaker_tpu.train.checkpoint import save_params

    corpus = write_corpus(tmp)
    cfg = jax_load_config(ROOT / "config", "train_eval", overrides(corpus, tmp))
    task, _ = build_model_and_task(cfg, 5)  # 8 speakers, 3 of them test
    params, _ = task.init(jax.random.PRNGKey(7), {"features": jnp.zeros((2, SR))})
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])

    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    objectives, printed = {}, {}
    try:
        for resumed, extra in zip((False, True), legs):
            for name, init in (("jax", tmp / "init"), ("torch", tmp / "init.npz")):
                argv = overrides(corpus, tmp / name, f"load_network_from_checkpoint={init}", *extra,
                                 *(["trainer.num_devices=2"] if name == "jax" else []))
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    objectives[name, resumed] = (
                        jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu"))
                printed[name, resumed] = out.getvalue()
                sys.stdout.write(printed[name, resumed])
    finally:
        monkeypatch.undo()
    return corpus, rec, objectives, printed, tmp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``FIRST`` runs, then their ``RESUMED`` runs."""
    return package_runs(tmp_path_factory.mktemp("torch_run"), (FIRST, RESUMED))


def test_run_matches_jax_run(runs):
    """Steps 1-4 and 5-6 (resumed): the same losses; the sanity, interval
    and test evaluations and the objectives equal."""
    _, rec, objectives, _, tmp = runs
    jax_steps, torch_steps = rec.steps["jax"], rec.steps["torch"]
    assert [s for s, _ in torch_steps] == [s for s, _ in jax_steps] == [*range(1, 5), *range(5, 7)]
    np.testing.assert_allclose([v for _, v in torch_steps], [v for _, v in jax_steps], rtol=0, atol=LOSS_ATOL)
    for (s_got, got), (s_want, want) in zip(rec.evals["torch"], rec.evals["jax"], strict=True):
        assert s_got == s_want and sorted(got) == sorted(want)
        for k, v in got.items():  # EER and minDCF exact, their thresholds (scores) within 1e-5
            assert v == pytest.approx(want[k], rel=0, abs=1e-5 if k.endswith("threshold") else 0), k
    steps = [s for s, _ in rec.evals["torch"]]
    evals = [m for _, m in rec.evals["torch"]]
    # sanity at 0, validations at 2, 3 and 4, the test; resumed: sanity at
    # 4, validation at 6, the test
    assert steps[:4] == [0, 2, 3, 4] and steps[5:7] == [4, 6] and len(steps) == 8
    assert {"sanity_val_eer", "val_eer", "test_eer"} <= {k for m in evals for k in m}
    assert 0 < evals[1]["val_eer"] < 1 and 0 < evals[4]["test_eer"] < 1
    assert objectives["torch", False] == objectives["jax", False] == evals[4]["test_eer"]
    assert objectives["torch", True] == objectives["jax", True] == evals[7]["test_eer"]
    for name in ("jax", "torch"):
        assert sorted(p.name for p in (tmp / name / "ckpt").iterdir()) == sorted(
            p.name for p in (tmp / "jax" / "ckpt").iterdir())


def test_epoch_limits_and_checkpoint_averaging_match_jax(runs):
    """The first run: ``limit_train_batches=2`` epochs validate at each
    epoch's end (steps 2 and 4) besides the interval step 3,
    ``max_epochs=2`` ends it at step 4 of ``max_steps=20``, and both
    packages test the average of the same best 2 checkpoints."""
    _, rec, _, printed, _ = runs
    for name in ("jax", "torch"):  # the first run's five evaluations
        assert [s for s, m in rec.evals[name][:5] if "val_eer" in m] == [2, 3, 4]
    averaged = [[line for line in printed[name, False].splitlines() if line.startswith("checkpoint averaging:")]
                for name in ("jax", "torch")]
    assert averaged[0] == averaged[1] and len(averaged[1]) == 1
    assert averaged[1][0].startswith("checkpoint averaging: 2 best checkpoints")


def test_eval_only_reproduces_the_fit_objective(runs, tmp_path):
    """``eval_model=false`` trains and returns None; ``fit_model=false`` with
    ``load_network_from_checkpoint=<ckpt>/best`` trains nothing, saves
    nothing and scores the best checkpoint's weights as the fit run did."""
    corpus, rec, objectives, _, tmp = runs
    shards = f"data.module.shards_dir={tmp / 'torch' / 'shards'}"
    assert trun.main(overrides(corpus, tmp_path, "eval_model=false", "trainer.max_steps=2",
                               "trainer.val_check_interval=2", shards), device="cpu") is None
    assert (tmp_path / "ckpt" / "last" / "state.pt").exists()
    best = tmp / "torch" / "ckpt" / "best"
    got = trun.main(overrides(corpus, tmp_path / "eval", "fit_model=false", f"load_network_from_checkpoint={best}",
                              shards), device="cpu")
    assert not (tmp_path / "eval" / "ckpt" / "last").exists()
    assert got == objectives["torch", True]  # the resumed run restored the same best


def test_int8_eval_only_matches_jax(runs, tmp_path):
    """``network.int8_matmuls=true`` with ``fit_model=false``: each package
    scores its own fit run's best checkpoint with int8 dense sites and no
    training; the test EERs equal (the two packages' int8 scores lie ~1e-5
    apart, ``tests/test_torch_quant.py``, far from any threshold here)."""
    import run as jrun

    corpus, _, _, _, tmp = runs
    got = {}
    for name in ("jax", "torch"):
        argv = overrides(corpus, tmp_path / name, "fit_model=false", "network.int8_matmuls=true",
                         f"load_network_from_checkpoint={tmp / name / 'ckpt' / 'best'}",
                         f"data.module.shards_dir={tmp / name / 'shards'}")
        got[name] = jrun.main(argv) if name == "jax" else trun.main(argv, device="cpu")
        assert not (tmp_path / name / "ckpt" / "last").exists()
    assert got["torch"] == got["jax"] and 0 < got["torch"] < 1


@pytest.mark.parametrize("kwargs, values", [
    (dict(patience=2), [0.3, 0.2, 0.25, 0.22, 0.19, 0.3, 0.3]),
    (dict(patience=1, min_delta=0.05), [0.3, 0.27, 0.2, 0.19]),
    (dict(divergence_threshold=0.45), [0.3, 0.5]),
    (dict(mode="max", patience=1), [0.1, 0.2, 0.2]),
    (dict(check_finite=True), [0.3, float("nan")]),
])
def test_early_stopping_decisions_match_jax(kwargs, values):
    got, want = texp.EarlyStopping(**kwargs), JaxEarlyStopping(**kwargs)
    decisions = [(got.update({"val_eer": v}), want.update({"val_eer": v})) for v in values]
    assert all(g == w for g, w in decisions) and decisions[-1][0] is not None
    assert texp.EarlyStopping().update({"val_mdc": 0.1}) is None


def _tb_scalars(log_dir: pathlib.Path):
    """[(step, tag, value)] of the scalar events of the TensorBoard files in
    ``log_dir``, in file order (the wire format of ``runtime/tb_writer.py``)."""
    def fields(buf):
        i, out = 0, []
        while i < len(buf):
            key, i = _varint(buf, i)
            field, wire = key >> 3, key & 7
            if wire == 0:
                val, i = _varint(buf, i)
            elif wire == 1:
                val, i = buf[i:i + 8], i + 8
            elif wire == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                n, i = _varint(buf, i)
                val, i = buf[i:i + n], i + n
            out.append((field, val))
        return out

    scalars = []
    for path in sorted(log_dir.glob("events.out.tfevents.*")):
        data, i = path.read_bytes(), 0
        while i < len(data):
            n = int.from_bytes(data[i:i + 8], "little")
            event = dict(fields(data[i + 12:i + 12 + n]))
            i += 16 + n
            if 5 not in event:
                continue
            value = dict(fields(dict(fields(event[5]))[1]))
            if 2 in value:
                scalars.append((event[2], value[1].decode(), float(np.frombuffer(value[2], "<f4")[0])))
    return scalars


def _varint(buf, i):
    shift = out = 0
    while True:
        b = buf[i]
        out |= (b & 0x7F) << shift
        i, shift = i + 1, shift + 7
        if not b & 0x80:
            return out, i


def test_data_parallel_run_matches_jax_and_one_rank(runs, tmp_path, capfd, monkeypatch):
    """``trainer.num_devices=2`` on the CPU: the fixture's first run (steps
    1-4, the sanity, interval and test evaluations, checkpoint averaging)
    on two gloo ranks that the run spawns. Its per-step losses (read back
    from rank 0's TensorBoard file, float32) equal the JAX package's
    2-device run's and the port's 1-rank run's within 1e-5; its EERs and
    minDCFs equal theirs exactly (as float32), their thresholds within
    1e-5; the objective equals both."""
    corpus, rec, objectives, _, tmp = runs
    monkeypatch.setattr(pmesh, "GROUP_TIMEOUT_S", 60.0)  # the spawned ranks' groups
    argv = overrides(corpus, tmp_path, f"load_network_from_checkpoint={tmp / 'init.npz'}", *FIRST,
                     f"data.module.shards_dir={tmp / 'torch' / 'shards'}", "trainer.num_devices=2",
                     f"trainer.log_dir={tmp_path / 'tb'}")
    objective = trun.main(argv, device="cpu")
    assert "data parallel: rank 0 of 2 on cpu (gloo)" in capfd.readouterr().out
    scalars = _tb_scalars(tmp_path / "tb")
    losses = [(s, v) for s, tag, v in scalars if tag == "train/loss"]
    assert [s for s, _ in losses] == [1, 2, 3, 4]
    for name in ("jax", "torch"):
        np.testing.assert_allclose([v for _, v in losses], [v for _, v in rec.steps[name][:4]], rtol=0, atol=LOSS_ATOL)
    evals = {}
    for s, tag, v in scalars:
        split, _, key = tag.partition("/")
        if split != "train" and not key.endswith("seconds"):
            evals.setdefault((s, split, key.startswith("sanity")), {})[key] = v
    got = list(evals.values())
    for name in ("jax", "torch"):
        want = [m for _, m in rec.evals[name][:5]]
        assert [sorted(m) for m in got] == [sorted(m) for m in want]
        for g, w in zip(got, want):
            for k, v in w.items():
                assert g[k] == pytest.approx(float(np.float32(v)), rel=0, abs=1e-5 if k.endswith("threshold") else 0), k
    assert objective == objectives["jax", False] == objectives["torch", False]


def test_num_devices_above_the_cards_raises_before_reading(runs, tmp_path):
    """Two ranks asked of the card on a host without one: the run raises
    before it reads or writes anything (the JAX package would narrow to
    the devices it has)."""
    corpus, _, _, _, _ = runs
    with pytest.raises(DeviceError, match="trainer.num_devices=2 asks for 2 cards"):
        trun.main(overrides(corpus, tmp_path, "trainer.num_devices=2"))
    assert not (tmp_path / "shards").exists() and not (tmp_path / "ckpt").exists()
