"""The augmentation suite (``data/augment.py``), its native DSP library
(``utils/native.py``) and ``build_augmenter`` against the JAX package's on
the CPU:

- every DSP function and every effect bit for bit (atol 0) at fixed seeds,
  through the scipy branch and through the scipy-free branch (both
  modules' ``_HAS_SCIPY`` switched off: the native library, the other
  band-reject taps, the RIR's Python loop);
- the native ``upfirdn`` / ``fir_same`` / ``fft_convolve`` and
  ``speed_perturb_native`` against scipy within ``tests/test_native.py``'s
  limits, the library built into ``build/torch_native/`` under a hashed
  name, and a failed build raising;
- ``build_augmenter`` over the three augment pipelines and the
  ``spec_augment_speeds`` and ``speed`` options: the same effects, order,
  names and seeds; the ``Augmenter``'s stack / yield semantics (with the
  reference's quirk: ``yield_unaugmented`` acts only with
  ``yield_intermediate``); the RIRS effect over ``pointsource_noises``
  shards;
- the VoxCeleb train batches of ``xvector_all_augment_pipeline`` (and of
  the RIRS pipeline) equal to the JAX package's at one pipeline worker;
  at 4 workers (both packages) the batch count and distinct keys of one
  worker, the length-preserving effects' keys as often, and each
  ``choice_speed`` key's chunk count one that a speed factor allows.
"""

import dataclasses
import pathlib
from collections import Counter
from fractions import Fraction

import numpy as np
import pytest
from scipy import signal

from w2v2_speaker_tpu.data import augment as jaug
from w2v2_speaker_tpu.data import datamodule as jdm
from w2v2_speaker_tpu.data.samples import SpeakerSample as JaxSample
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu.utils import native as jnative
from w2v2_speaker_tpu_torch.data import augment as taug
from w2v2_speaker_tpu_torch.data import datamodule as tdm
from w2v2_speaker_tpu_torch.data import io as tio
from w2v2_speaker_tpu_torch.data.samples import SpeakerSample
from w2v2_speaker_tpu_torch.data.shards import ShardWriter
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.utils import native as tnative

from test_torch_datamodule import write_corpus

SR = 16000
PIPELINES = ("xvector_all_augment_pipeline", "xvector_dropout_augment_pipeline", "xvector_rirs_augment")


def _wav(n=12000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 0.1, n)).astype(np.float32)


@pytest.fixture(params=["scipy", "native"])
def branch(request, monkeypatch):
    """Both modules on the scipy branch, or both on the scipy-free one."""
    if request.param == "native":
        if jnative.load() is None:
            pytest.fail("the JAX package's native DSP library did not build")
        monkeypatch.setattr(jaug, "_HAS_SCIPY", False)
        monkeypatch.setattr(taug, "_HAS_SCIPY", False)
    return request.param


def test_dsp_core_matches_jax(branch):
    wav = _wav()
    for factor in (0.9, 0.95, 1.0, 1.05, 1.1):
        np.testing.assert_array_equal(taug.speed_perturb(wav, factor), jaug.speed_perturb(wav, factor))
    for up, down in ((20, 19), (19, 20), (2, 3)):
        np.testing.assert_array_equal(taug._firwin_kaiser(2 * 10 * max(up, down) + 1, 1.0 / max(up, down)),
                                      jaug._firwin_kaiser(2 * 10 * max(up, down) + 1, 1.0 / max(up, down)))
    noise = np.random.default_rng(1).random(9000).astype(np.float32)
    for snr in (5, 20, 100):
        np.testing.assert_array_equal(taug.add_noise_snr(wav, noise, snr), jaug.add_noise_snr(wav, noise, snr))
    for args in ((50, 50, 0), (30, 80, 100), (100, 0, 37)):
        np.testing.assert_array_equal(taug.synthetic_rir(np.random.default_rng(3), SR, *args),
                                      jaug.synthetic_rir(np.random.default_rng(3), SR, *args))
    for low, high in ((300.0, 900.0), (0.5, 200.0), (3000.0, 9000.0), (500.0, 400.0)):
        np.testing.assert_array_equal(taug.band_reject(wav, low, high, SR), jaug.band_reject(wav, low, high, SR))


def _effects(mod, shards=None):
    effects = [
        mod.UniformSpeedAugment(seed=1), mod.ChoiceSpeedAugment(seed=6),
        mod.TimeDropoutAugment(max_dropout_length_seconds=0.25, min_drop_count=0, max_drop_count=5, seed=2),
        mod.FrequencyDropoutAugment(min_drop_count=0, max_drop_count=5, seed=5),
        mod.ChoiceRandomNoiseAugment(snr_choices=(15, 20, 100), seed=3),
        mod.ReverbAugment(seed=4), mod.SpecAugmentTimeDomain(speeds=(95, 100, 105), seed=7),
    ]
    if shards is not None:
        effects.append(mod.ChoiceRirsNoiseAugment(shards, snr_choices=(5,), seed=3))
    return effects


def write_noise_shards(root: pathlib.Path, n_shards=2, per_shard=3) -> pathlib.Path:
    """``pointsource_noises-NNNNNN.tar`` shards of noise bursts of 0.3-1 s
    (shorter than the inputs, so the effect tiles them) and one shard of
    another name that the effect must not read."""
    rng = np.random.default_rng(9)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_shards):
        with ShardWriter(root / f"pointsource_noises-{i:06d}.tar") as w:
            for j in range(per_shard):
                w.write(f"noise/{i}/{j}", rng.normal(0, 0.2, int(rng.uniform(0.3, 1.0) * SR)).astype(np.float32),
                        {"sampling_rate": SR})
    with ShardWriter(root / "other-000000.tar") as w:
        w.write("other/0", np.full(SR, 9.0, np.float32), {"sampling_rate": SR})
    return root


def test_every_effect_matches_jax(branch, tmp_path):
    """Each effect four times over inputs of three lengths, from the same
    seed in both packages: every output equal, names equal."""
    shards = write_noise_shards(tmp_path / "rirs")
    for got_fx, want_fx in zip(_effects(taug, shards), _effects(jaug, shards), strict=True):
        assert got_fx.name == want_fx.name
        for i, n in enumerate((12000, 7001, 20000, 12000)):
            wav = _wav(n, seed=i)
            np.testing.assert_array_equal(got_fx.process(wav), want_fx.process(wav), err_msg=got_fx.name)
    assert _effects(taug)[-1].name == "speed95_100_105"


def test_rirs_effect_streams_only_its_shards_and_raises_without(tmp_path):
    fx = taug.ChoiceRirsNoiseAugment(write_noise_shards(tmp_path / "rirs"), snr_choices=(5,), seed=3)
    outs = [fx.process(np.zeros(SR, np.float32)) for _ in range(8)]  # 6 noises, then repeated
    assert all(np.abs(o).max() < 5 for o in outs)  # never the constant 9.0 "other" shard
    with pytest.raises(ValueError, match="no pointsource_noises shards"):
        taug.ChoiceRirsNoiseAugment(tmp_path / "rirs" / "..", seed=0).process(np.zeros(10, np.float32))


@pytest.mark.parametrize("stack, intermediate, unaugmented", [
    (True, False, False), (True, True, False), (True, True, True), (False, True, True), (False, True, False),
    (True, False, True),  # the quirk: yield_unaugmented without yield_intermediate yields the last sample alone
])
def test_augmenter_semantics_match_jax(stack, intermediate, unaugmented):
    def run(mod, sample_cls):
        aug = mod.Augmenter(_effects(mod)[:3], stack, intermediate, unaugmented)
        captured = []
        out = aug(sample_cls("id0/yt0/u", _wav(9000), 3, {"a": 1}), capture=lambda s, w: captured.append((s, w)))
        return [(s.key, s.wav, s.ground_truth) for s in out], captured

    got, got_cap = run(taug, SpeakerSample)
    want, want_cap = run(jaug, JaxSample)
    assert [(k, g) for k, _, g in got] == [(k, g) for k, _, g in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [s for s, _ in got_cap] == [s for s, _ in want_cap] == [
        "augment_uniform_speed", "augment_choice_speed", "augment_time_dropout"]
    if unaugmented and not intermediate:
        assert len(got) == 1 and got[0][0].count("/") == 5  # the stacked chain's last sample
    with pytest.raises(ValueError, match="at least stack augmentations or yield"):
        taug.Augmenter([], stack_augmentations=False, yield_intermediate_augmentations=False)


def _pipeline_cfgs():
    cfgs = {name: texp.load_recipe("speaker_xvector", [f"data/pipeline={name}", "data_folder=/data"])
            ["data"]["pipeline"] for name in PIPELINES}
    base = cfgs["xvector_dropout_augment_pipeline"]["augment"]
    cfgs["spec_augment_speeds"] = {"augment": {**base, "spec_augment_speeds": [90, 100, 110]}}
    cfgs["speed"] = {"augment": {"enabled": True, "speed": {"min": 0.9, "max": 1.1}, "reverb": True,
                                 "time_dropout": {}, "stack": True}}
    cfgs["disabled"] = {"augment": {**base, "enabled": False}}
    cfgs["empty"] = {"augment": {"enabled": True, "time_dropout": None, "reverb": False}}
    return cfgs


@pytest.mark.parametrize("name", sorted(_pipeline_cfgs()))
def test_build_augmenter_matches_jax(name):
    cfg = _pipeline_cfgs()[name]
    got, want = texp.build_augmenter(cfg, 17), jexp.build_augmenter(cfg, 17)
    if want is None:
        assert got is None and name in ("disabled", "empty")
        return
    assert (got.stack, got.yield_intermediate, got.yield_unaugmented) == (
        want.stack, want.yield_intermediate, want.yield_unaugmented)
    assert [type(e).__name__ for e in got.augmenters] == [type(e).__name__ for e in want.augmenters]
    for g, w in zip(got.augmenters, want.augmenters):
        public = {k: v for k, v in vars(w).items() if k not in ("rng", "_iter", "_lock")}
        assert {k: v for k, v in vars(g).items() if k not in ("rng", "_iter", "_lock")} == public
        assert g.rng.integers(0, 2**31, 4).tolist() == w.rng.integers(0, 2**31, 4).tolist()  # the same seed


def test_native_library_against_scipy_and_its_build(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.normal(size=1000).astype(np.float32)
    taps = signal.firwin(41, 0.3).astype(np.float32)
    for up, down in [(1, 1), (2, 3), (3, 2), (20, 21), (21, 20)]:
        want = signal.upfirdn(taps.astype(np.float64), x.astype(np.float64), up, down)
        got = tnative.upfirdn(x, taps, up, down)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    x = rng.normal(size=4096).astype(np.float32)
    taps = signal.firwin(255, [0.1, 0.4], pass_zero=True).astype(np.float32)
    np.testing.assert_allclose(tnative.fir_same(x, taps), signal.fftconvolve(x, taps, mode="same"),
                               rtol=1e-4, atol=1e-6)
    x, h = rng.normal(size=5000).astype(np.float32), rng.normal(size=700).astype(np.float32)
    got = tnative.fft_convolve(x, h)
    assert got.shape == (5699,)
    np.testing.assert_allclose(got, signal.fftconvolve(x, h), rtol=2e-4, atol=2e-4)
    x = rng.normal(size=16000).astype(np.float32)
    for factor in (0.9, 0.95, 1.05, 1.1):
        frac = taug.Fraction(1.0 / factor).limit_denominator(100)
        want = signal.resample_poly(x, frac.numerator, frac.denominator).astype(np.float32)
        got = taug.speed_perturb_native(x, frac.numerator, frac.denominator)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR and path.parts[-3:-1] == ("build", "torch_native")
    assert path.name.startswith("libdsp-") and len(path.stem.split("-")[1]) == 16
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(taug, "_HAS_SCIPY", False)
    with pytest.raises(RuntimeError, match="building the DSP library"):
        taug.speed_perturb(x, 0.9)
    with pytest.raises(RuntimeError, match="building the DSP library"):
        taug.ReverbAugment(seed=0).process(x)
    assert not list((tmp_path / "build").glob("*.so"))


def _augmented_modules(root, pipeline: str, workers: int = 1, rirs=None):
    """Both packages' VoxCeleb modules over one WAV tree with the augmenter
    of ``pipeline`` (``chunk_strategy`` contiguous, 1 s chunks) and a queue
    that holds an epoch."""
    wav_dir, trials = write_corpus(root)
    overrides = [f"data/pipeline={pipeline}"] + ([f"data.pipeline.augment.rirs_shards={rirs}"] if rirs else [])
    p = texp.load_recipe("speaker_xvector", overrides)["data"]["pipeline"]
    kw = dict(data_dir=wav_dir, test_trial_path=trials, train_val_split_mode="equal", train_val_ratio=0.7,
              samples_per_shard=6, batch_size=8, queue_size=500, chunk_length_sec=1.0,
              chunk_strategy=p["chunk_strategy"], eer_validation_pairs=8, seed=11, num_pipeline_workers=workers)
    jax_dm = jdm.VoxCelebDataModule(jdm.VoxCelebConfig(shards_dir=root / "jax_shards",
                                                       augmenter=jexp.build_augmenter(p, 11), **kw))
    torch_dm = tdm.VoxCelebDataModule(tdm.VoxCelebConfig(shards_dir=root / "torch_shards",
                                                         augmenter=texp.build_augmenter(p, 11), **kw))
    jax_dm.prepare_data()
    torch_dm.prepare_data()
    return jax_dm, torch_dm


def _epochs(dm, n=2):
    return [list(dm.train_batches(epoch=e)) for e in range(n)]


@pytest.mark.parametrize("pipeline", ["xvector_all_augment_pipeline", "xvector_rirs_augment"])
def test_augmented_train_batches_equal_jax(tmp_path, pipeline):
    """Two epochs at one worker: every batch equal, keys included; the
    augmenter's samples are all there (each utterance unaugmented and
    after each effect: the pipelines yield the intermediates unstacked);
    validation is never augmented."""
    rirs = write_noise_shards(tmp_path / "rirs") if pipeline == "xvector_rirs_augment" else None
    jax_dm, torch_dm = _augmented_modules(tmp_path, pipeline, rirs=rirs)
    got, want = _epochs(torch_dm), _epochs(jax_dm)
    for g_epoch, w_epoch in zip(got, want, strict=True):
        assert len(g_epoch) == len(w_epoch) > 0
        for g, w in zip(g_epoch, w_epoch):
            assert sorted(g) == sorted(w) and list(g["keys"]) == list(w["keys"])
            for k in g:
                if k != "keys":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    effects = {"xvector_all_augment_pipeline": {"", "time_dropout", "frequency_dropout", "choice_speed",
                                                "add_reverb", "uniform_noise"},
               "xvector_rirs_augment": {"", "rirs_background_noise"}}[pipeline]
    by_utterance = {}
    for k in (k for b in got[0] for k in b["keys"]):
        by_utterance.setdefault("/".join(k.split("/")[:3]), set()).add("/".join(k.split("/")[3:]))
    assert by_utterance and all(names == effects for names in by_utterance.values())
    assert all(k.count("/") == 2 for b in torch_dm.val_batches() for k in b["keys"])


def _speed_chunk_counts(n: int, factors, chunk: int = SR) -> set:
    """The whole 1 s chunks that ``speed_perturb`` leaves of ``n`` samples
    at each factor (its output has ceil(n x up / down) samples)."""
    fracs = [Fraction(1.0 / f).limit_denominator(100) for f in factors]
    return {-(-n * fr.numerator // fr.denominator) // chunk for fr in fracs}


def test_four_workers_give_the_same_count_and_keys(tmp_path):
    """At 4 pipeline workers the effects of both packages draw from one
    shared generator each, in the order the threads reach it, so which
    utterance gets which ``choice_speed`` factor changes from run to run,
    and with the factor an utterance's count of whole 1 s chunks. What 4
    workers guarantee, and both packages give: the same distinct keys
    (utterance x effect) as the port at 1 worker, every ``choice_speed``
    key's chunk count one that a speed factor gives for its utterance, the
    keys of the length-preserving effects exactly as often as at 1 worker,
    and the batch count that every such total gives."""
    jax_dm, torch_dm = _augmented_modules(tmp_path, "xvector_all_augment_pipeline", workers=4)
    four = {"jax": _epochs(jax_dm, 1)[0], "torch": _epochs(torch_dm, 1)[0]}
    one = _epochs(_augmented_modules(tmp_path / "one", "xvector_all_augment_pipeline")[1], 1)[0]
    factors = texp.load_recipe("speaker_xvector", ["data/pipeline=xvector_all_augment_pipeline"])[
        "data"]["pipeline"]["augment"]["speed_choices"]
    want = Counter(k for b in one for k in b["keys"])
    allowed = {k: _speed_chunk_counts(tio.load_raw_audio(tmp_path / "wav" / f"{k.rsplit('/', 1)[0]}.wav").shape[-1],
                                      factors)
               for k in want if k.endswith("/choice_speed")}
    assert allowed and all(want[k] in counts for k, counts in allowed.items())
    totals = [sum(want.values()) + sum(pick(c) - want[k] for k, c in allowed.items()) for pick in (min, max)]
    batch_size = len(one[0]["keys"])
    assert {-(-t // batch_size) for t in totals} == {len(one)}  # every possible total fills as many batches
    for name, batches in four.items():
        got = Counter(k for b in batches for k in b["keys"])
        assert len(batches) == len(one), name
        assert set(got) == set(want), name
        assert all(got[k] in allowed[k] for k in allowed), (name, {k: got[k] for k in allowed})
        assert {k: n for k, n in got.items() if k not in allowed} == {
            k: n for k, n in want.items() if k not in allowed}, name


def test_config_carries_the_augmenter_into_the_train_split_only():
    cfg = tdm.VoxCelebConfig()
    assert cfg.augmenter is None and cfg.debug_capture is None
    fields = {f.name for f in dataclasses.fields(tdm.VoxCelebConfig)}
    assert {f.name for f in dataclasses.fields(jdm.VoxCelebConfig)} == fields


def test_rirs_stream_is_shared_safely_by_worker_threads(tmp_path):
    """``num_pipeline_workers`` > 1 runs the effect from several threads at
    once: the port reads its noise stream under a lock (the JAX module's
    generator raises "generator already executing" when two threads read
    it at once), so every call returns and the bursts are all used."""
    import concurrent.futures as cf

    fx = taug.ChoiceRirsNoiseAugment(write_noise_shards(tmp_path / "rirs"), snr_choices=(5,), seed=3)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        outs = list(pool.map(lambda i: fx.process(np.zeros(SR, np.float32)), range(64)))
    assert len(outs) == 64 and all(np.isfinite(o).all() and np.abs(o).max() > 0 for o in outs)
