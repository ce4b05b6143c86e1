"""Serving path of the port against the JAX package: bucketed extraction,
pair scores, the pair-file reader, the collate copies, and the ``predict.py``
twin end to end (config, weights exported from a JAX checkpoint, audio,
cache, evaluator, score file) against the JAX package's ``predict.main``,
in one process and on two gloo ranks (``trainer.num_devices=2``: the world
spawned once, a 60 s group timeout and a 240 s deadline); more ranks than
cards raise before anything is read."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.data import collate as jcollate
from w2v2_speaker_tpu.data.samples import SpeakerSample as JaxSample
from w2v2_speaker_tpu.eval.evaluator import CosineDistanceEvaluator, EmbeddingSample as JaxEmbedding
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.parallel.mesh import pad_batch_rows as jax_pad_batch_rows
from w2v2_speaker_tpu.runtime import predict as jpredict
from w2v2_speaker_tpu.runtime.experiment import extract_embeddings as jax_extract
from w2v2_speaker_tpu_torch.data import collate as tcollate
from w2v2_speaker_tpu_torch.data.samples import SpeakerSample
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.eval.evaluator import CosineDistanceEvaluator as TorchCosine
from w2v2_speaker_tpu_torch.eval.evaluator import EmbeddingSample as TorchEmbedding
from w2v2_speaker_tpu_torch.runtime import predict as tpredict

ROOT = pathlib.Path(__file__).resolve().parents[1]

TINY = dict(
    conv_dim=(16, 16),
    conv_kernel=(10, 3),
    conv_stride=(5, 2),
    hidden_size=32,
    num_layers=2,
    num_heads=4,
    intermediate_size=64,
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
    layerdrop=0.0,
)
LENGTHS = [1700, 830, 2410, 1290, 3000, 640]  # ~6 utterances of mixed length


@functools.lru_cache(maxsize=None)
def _embeddings():
    """(JAX embeddings, port embeddings) by key, extracted from the same
    utterances at the same weights in buckets of 800 samples, batch 4."""
    jm = js.Wav2Vec2SpeakerModel(
        cfg=js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY)), num_speakers=8
    )
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 1600)))
    embed = jax.jit(lambda v, x, m: jm.apply(v, x, m, method=js.Wav2Vec2SpeakerModel.compute_embedding))
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY))
    tm = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=8).eval()
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"]), cfg))

    rng = np.random.default_rng(5)
    wavs = [rng.normal(0, 0.5, n).astype(np.float32) for n in LENGTHS]
    want = jax_extract(
        embed, variables, [JaxSample(f"u{i}", w, -1) for i, w in enumerate(wavs)],
        pad_to_multiple=800, batch_size=4,
    )
    got = tpredict.extract_embeddings(
        tm, [SpeakerSample(f"u{i}", w) for i, w in enumerate(wavs)],
        pad_to_multiple=800, batch_size=4, device="cpu",
    )
    return {e.sample_id: np.asarray(e.embedding) for e in want}, {
        e.sample_id: e.embedding for e in got
    }


def test_extract_embeddings_matches_jax():
    want, got = _embeddings()
    assert sorted(got) == sorted(want) == [f"u{i}" for i in range(len(LENGTHS))]
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


def test_score_pairs_matches_jax_evaluator():
    """The port's cosine evaluator and the (s + 1) / 2 clip of predict
    (``runtime/predict.py:177-180``) on the port's embeddings, against the
    JAX package's on its own: 1e-5."""
    want_emb, got_emb = _embeddings()
    keys = sorted(want_emb)
    pairs = [(a, b) for a in keys for b in keys if a < b]
    evaluator = CosineDistanceEvaluator()
    raw = evaluator._compute_prediction_scores(
        [(JaxEmbedding(a, want_emb[a]), JaxEmbedding(b, want_emb[b])) for a, b in pairs]
    )
    want = np.clip((np.asarray(raw) + 1) / 2, 0, 1)  # runtime/predict.py:180
    got = TorchCosine()._compute_prediction_scores(
        [(TorchEmbedding(a, got_emb[a]), TorchEmbedding(b, got_emb[b])) for a, b in pairs])
    got = np.clip((np.asarray(got) + 1) / 2, 0, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all((got >= 0) & (got <= 1))


def test_extract_embeddings_needs_a_device():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.extract_embeddings(None, [SpeakerSample("a", np.zeros(800, np.float32))])


def test_read_pair_file_matches_jax(tmp_path):
    path = tmp_path / "pairs.txt"
    path.write_text("1 a/1.wav b/2.wav\nc/3.wav d/4.wav\n\n0 e/5.wav f/6.wav\nbad\n")
    got = tpredict.read_pair_file(path)
    assert got == jpredict.read_pair_file(path)
    assert got == [("a/1.wav", "b/2.wav"), ("c/3.wav", "d/4.wav"), ("e/5.wav", "f/6.wav")]


@pytest.mark.parametrize("pad_to_multiple, boundaries", [(None, None), (800, None), (None, [1000, 4000])])
def test_collate_copies_match_jax(pad_to_multiple, boundaries):
    rng = np.random.default_rng(0)
    samples = [rng.normal(size=n).astype(np.float32) for n in (700, 950, 31)]
    got = tcollate.collate_pad_right(samples, pad_to_multiple=pad_to_multiple, bucket_boundaries=boundaries)
    want = jcollate.collate_pad_right(samples, pad_to_multiple=pad_to_multiple, bucket_boundaries=boundaries)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.mask, want.mask)
    for n in (1, 799, 800, 801, 3999):
        assert tcollate.bucket_length(n, pad_to_multiple, boundaries) == jcollate.bucket_length(
            n, pad_to_multiple, boundaries
        )
    batch = {"features": got.values, "mask": got.mask}
    for fill in (False, True):
        for key, value in tcollate.pad_batch_rows(batch, 5, mask_fill=fill).items():
            np.testing.assert_array_equal(value, jax_pad_batch_rows(batch, 5, mask_fill=fill)[key])
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        tcollate.bucket_length(5000, None, [1000, 4000])


def test_padding_ratio_of_the_chip_smoke_check():
    """``chip_smoke.padding_ratio`` reads 0 for equal embeddings, small for
    a small shift, and at least 1 for two embeddings handed back swapped."""
    import chip_smoke

    rng = np.random.default_rng(0)
    alone = {f"u{i}": rng.normal(size=8).astype(np.float32) for i in range(5)}
    assert chip_smoke.padding_ratio(alone, alone) == 0
    near = {k: v + 1e-3 for k, v in alone.items()}
    assert 0 < chip_smoke.padding_ratio(near, alone) < 0.1
    for a, b in (("u0", "u1"), ("u2", "u4")):
        swapped = dict(alone, **{a: alone[b], b: alone[a]})
        assert chip_smoke.padding_ratio(swapped, alone) >= 1


# --------------------------------------------------------------- predict.py

PREDICT_OVERRIDES = ["network=wav2vec2_fc", "network.wav2vec2_size=tiny", "trainer.precision=f32",
                     "data.dataloader.test_pad_to_multiple=8000", "data.dataloader.test_batch_size=4"]
PREDICT_SECONDS = (0.6, 1.1, 0.9, 1.4, 0.7)
SCORE_ATOL = 1e-5
# two ranks against one process: the same model and batches, each rank's
# rows through float32 products of another row count
RANKS_ATOL = 1e-6
WORLD, DEADLINE, GROUP_TIMEOUT = 2, 240.0, 60.0


def _write_folder(folder):
    """5 WAV files in VoxCeleb-style paths (2 speakers) and a labelled
    trial file over every pair; returns the trial file. Each file is a
    harmonic tone at its speaker's pitch plus a little noise: from white
    noise alone the tiny random model's embeddings all lie within cosine
    0.996 of each other, AS-Norm's top-K cohort spread is then ~1e-3, and
    the two packages' float32 embeddings (1.5e-7 apart) read up to 5e-5
    apart as scores; the tones spread the cosines to 0.96 and the cohort to
    ~2e-2."""
    from w2v2_speaker_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(11)
    ids = []
    for i, sec in enumerate(PREDICT_SECONDS):
        rel = f"id{i % 2:05d}/yt{i}/{i:05d}.wav"
        t = np.arange(int(sec * 16000)) / 16000
        f0 = (120, 210)[i % 2] * (1 + 0.05 * i)
        wav = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6)) * (1 + 0.5 * np.sin(6 * np.pi * t))
        (folder / rel).parent.mkdir(parents=True, exist_ok=True)
        write_wav(folder / rel, (0.2 * wav + rng.normal(0, 0.02, t.shape)).astype(np.float32))
        ids.append(rel)
    trials = folder / "trials.txt"
    trials.write_text("".join(f"{int(a[:7] == b[:7])} {a} {b}\n" for i, a in enumerate(ids) for b in ids[i + 1:]))
    return trials


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny wav2vec2_fc model's params saved by the JAX package's
    ``save_params`` and exported by ``tools/export_jax_params.py``:
    (checkpoint dir, .npz)."""
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.runtime.experiment import build_model_and_task
    from w2v2_speaker_tpu.train.checkpoint import save_params

    tmp = tmp_path_factory.mktemp("ckpt")
    cfg = jax_load_config(ROOT / "config", "predict", PREDICT_OVERRIDES)
    task, _ = build_model_and_task(cfg, 2)
    batch = {"features": jnp.zeros((2, 16000)), "mask": jnp.ones((2, 16000), bool),
             "labels": jnp.zeros((2,), jnp.int32)}
    params, _ = task.init(jax.random.PRNGKey(7), batch)
    save_params(tmp / "ckpt", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "ckpt"), str(tmp / "params.npz")])
    return tmp / "ckpt", tmp / "params.npz"


def _scores(path):
    lines = [line.split(" ") for line in pathlib.Path(path).read_text().splitlines()]
    return np.array([float(x[0]) for x in lines]), [tuple(x[1:]) for x in lines]


_JAX_SCORES = {}


def _jax_scores(tmp_path_factory, ckpt, evaluator):
    """The JAX package's ``predict.main`` on a folder of ``_write_folder``
    with ``evaluator``: (scores, pairs), one run an evaluator for the
    module."""
    import predict as jax_predict

    if evaluator not in _JAX_SCORES:
        folder = tmp_path_factory.mktemp("jax")
        trials = _write_folder(folder)
        _JAX_SCORES[evaluator] = _scores(jax_predict.main(
            [*PREDICT_OVERRIDES, f"evaluator={evaluator}", f"predict_folder_path={folder}",
             f"pair_prediction_path={trials}", f"load_network_from_checkpoint={ckpt}"]))
    return _JAX_SCORES[evaluator]


@pytest.mark.parametrize("evaluator", ["cosine_distance", "cosine_distance_asnorm"])
def test_predict_cli_matches_jax_predict(tmp_path_factory, jax_checkpoint, evaluator):
    """The port's ``predict.main`` against the JAX package's ``predict.main``
    on the same folder and the same weights (the JAX package's checkpoint,
    exported to ``.npz``): score files within 1e-5, the same pair order;
    a second port run is served from its embedding cache."""
    from w2v2_speaker_tpu_torch import predict as torch_predict

    ckpt, npz = jax_checkpoint
    runs = {}
    for name in ("jax", "torch"):
        if name == "jax":
            runs[name] = _jax_scores(tmp_path_factory, ckpt, evaluator)
        else:
            folder = tmp_path_factory.mktemp(name)
            trials = _write_folder(folder)
            argv = [*PREDICT_OVERRIDES, f"evaluator={evaluator}", f"predict_folder_path={folder}",
                    f"pair_prediction_path={trials}", f"load_network_from_checkpoint={npz}"]
            runs[name] = _scores(torch_predict.main(argv, device="cpu"))
            cached = sorted(p.relative_to(folder / "embeddings") for p in (folder / "embeddings").rglob("*.npy"))
            assert len(cached) == len(PREDICT_SECONDS)
            stamp = {p: (folder / "embeddings" / p).stat().st_mtime_ns for p in cached}
            again = _scores(torch_predict.main(argv, device="cpu"))
            assert {p: (folder / "embeddings" / p).stat().st_mtime_ns for p in cached} == stamp
            np.testing.assert_array_equal(again[0], runs[name][0])
    (want, want_pairs), (got, got_pairs) = runs["jax"], runs["torch"]
    assert got_pairs == want_pairs and len(got) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert np.all((got >= 0) & (got <= 1))


def test_predict_on_two_ranks_matches_one_process_and_jax(tmp_path_factory, jax_checkpoint):
    """``trainer.num_devices=2`` on two spawned gloo ranks (a caller's
    group, taken as given) against one process on the same folder and
    weights: the scores within 1e-6 and the same pair order, and against
    the JAX package's ``predict.main`` (8 CPU devices: its batches are
    sharded too) within 1e-5. Rank 0 alone saves the cache (one file an
    utterance) and returns the score file, and alone prints."""
    from tools import torch_parallel_cases as cases_mod  # the ranks import it too
    from w2v2_speaker_tpu_torch import predict as torch_predict
    from w2v2_speaker_tpu_torch.parallel.mesh import spawn

    ckpt, npz = jax_checkpoint
    runs, folders = {}, {}
    for name in ("one", "two"):
        folder = folders[name] = tmp_path_factory.mktemp(name)
        trials = _write_folder(folder)
        argv = [*PREDICT_OVERRIDES, "evaluator=cosine_distance", f"predict_folder_path={folder}",
                f"pair_prediction_path={trials}", f"load_network_from_checkpoint={npz}"]
        if name == "one":
            runs[name] = _scores(torch_predict.main([*argv, "trainer.num_devices=1"], device="cpu"))
        else:
            records = spawn(cases_mod.predict_rank, ([*argv, f"trainer.num_devices={WORLD}"],), nprocs=WORLD,
                            deadline=DEADLINE, timeout=GROUP_TIMEOUT, threads=1)
            runs[name] = _scores(records[0]["path"])
    (one, one_pairs), (two, two_pairs) = runs["one"], runs["two"]
    assert two_pairs == one_pairs and len(two) == 10
    np.testing.assert_allclose(two, one, rtol=0, atol=RANKS_ATOL)
    want, want_pairs = _jax_scores(tmp_path_factory, ckpt, "cosine_distance")
    assert two_pairs == want_pairs
    np.testing.assert_allclose(two, want, rtol=0, atol=SCORE_ATOL)
    cache = folders["two"] / "embeddings"
    assert sorted(str(p) for p in cache.rglob("*.npy")) == sorted(records[0]["saved"])
    assert len(records[0]["saved"]) == len(PREDICT_SECONDS)
    assert [r["rank"] for r in records] == [0, 1] and records[1]["saved"] == [] and records[1]["path"] is None
    assert "wrote " in records[0]["printed"] and records[1]["printed"] == ""


def test_predict_ranks_spawn_or_raise_before_reading(tmp_path, monkeypatch):
    """More ranks than the host's cards (none here) raise before anything
    is read; on the CPU a world of 2 with no process group is spawned here
    (``parallel.mesh.spawn``: 2 ranks, gloo, the ranks' intra-op threads
    split), each rank calling ``run_predictions`` again."""
    from w2v2_speaker_tpu_torch.device import DeviceError
    from w2v2_speaker_tpu_torch.runtime.config import load_config

    trials = tmp_path / "trials.txt"
    trials.write_text("1 a.wav b.wav\n")
    cfg = load_config(ROOT / "config", "predict", [*PREDICT_OVERRIDES, f"predict_folder_path={tmp_path}",
                                                    f"pair_prediction_path={trials}", "trainer.num_devices=2"])
    with pytest.raises(DeviceError, match="trainer.num_devices=2 asks for 2 cards"):
        tpredict.run_predictions(cfg)
    assert not (tmp_path / "embeddings").exists()
    calls = []
    monkeypatch.setattr(tpredict, "spawn", lambda fn, args, **kw: calls.append((fn, args, kw)) or "rank 0's path")
    monkeypatch.setattr(torch, "get_num_threads", lambda: 4)
    assert tpredict.run_predictions(cfg, "cpu") == "rank 0's path"
    assert calls == [(tpredict.run_predictions, (cfg, "cpu"), {"nprocs": 2, "device": "cpu", "threads": 2})]
    assert not (tmp_path / "embeddings").exists()


def test_load_params_grafts_matching_leaves(tmp_path):
    """A checkpoint whose head has another class count, or another layer
    count, leaves those leaves at their init and loads the rest, as the JAX
    package's ``load_params`` graft does; a directory (orbax) raises."""
    from w2v2_speaker_tpu_torch.train.checkpoint import load_params

    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY), use_aam=True)
    source = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=9)
    tw.init_parameters(source, torch.Generator().manual_seed(1))
    torch.save(source.state_dict(), tmp_path / "w.pt")
    target = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=2)
    tw.init_parameters(target, torch.Generator().manual_seed(2))
    init = {k: v.clone() for k, v in target.state_dict().items()}
    load_params(tmp_path / "w.pt", target)
    for name, value in target.state_dict().items():
        want = init[name] if name == "aam.weights" else source.state_dict()[name]
        assert torch.equal(value, want), name

    deeper = ts.Wav2Vec2SpeakerModel(
        ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**{**TINY, "num_layers": 3})), num_speakers=2)
    jm = js.Wav2Vec2SpeakerModel(cfg=js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY)), num_speakers=2)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1600)))["params"])
    flat = {}

    def walk(tree, prefix=""):
        for key, value in tree.items():
            walk(value, f"{prefix}{key}/") if isinstance(value, dict) else flat.__setitem__(prefix + key, value)

    walk(params)
    np.savez(tmp_path / "p.npz", **flat)
    with torch.no_grad():  # values no checkpoint leaf can hold by chance
        for value in deeper.parameters():
            value.uniform_(5.0, 6.0, generator=torch.Generator().manual_seed(3))
    init = {k: v.clone() for k, v in deeper.state_dict().items()}
    load_params(tmp_path / "p.npz", deeper)
    for name, value in deeper.state_dict().items():
        assert torch.equal(value, init[name]) == (".layers." in name), name
    with pytest.raises(ValueError, match="export_jax_params"):
        load_params(tmp_path, deeper)


@pytest.mark.parametrize("wrap", ["module_prefix", "lightning_dict", "backbone_only_names"])
def test_load_params_raises_when_no_backbone_entry_matches(tmp_path, wrap):
    """A file whose names are not the model's (a ``module.`` prefix, a
    ``{"state_dict": ...}`` wrapper, a bare backbone's names as an HF file
    has them) would graft nothing: it raises instead of serving the init."""
    from w2v2_speaker_tpu_torch.train.checkpoint import load_params

    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY))
    model = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=2)
    tw.init_parameters(model, torch.Generator().manual_seed(1))
    state = model.state_dict()
    saved = {
        "module_prefix": {f"module.{k}": v for k, v in state.items()},
        "lightning_dict": {"state_dict": state, "epoch": 3},
        "backbone_only_names": model.wav2vec2.state_dict(),
    }[wrap]
    torch.save(saved, tmp_path / "w.pt")
    init = {k: v.clone() for k, v in state.items()}
    with pytest.raises(ValueError, match=r"none of the model's wav2vec2\.\* entries"):
        load_params(tmp_path / "w.pt", model)
    assert all(torch.equal(v, init[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def full_precision_scores(tmp_path_factory):
    """The tiny network's float32 scores of ``_write_folder``'s pairs at
    ``test_predict_serves_int8``'s batching, served once for its cases."""
    from w2v2_speaker_tpu_torch import predict as torch_predict

    folder = tmp_path_factory.mktemp("full")
    return _scores(torch_predict.main(
        [*PREDICT_OVERRIDES, "data.dataloader.test_batch_size=2", "network.int8_matmuls=false",
         f"predict_folder_path={folder}", f"pair_prediction_path={_write_folder(folder)}"], device="cpu"))


@pytest.mark.parametrize("override", ["network.int8_matmuls=auto", "network.int8_matmuls=true"])
def test_predict_serves_int8(tmp_path, capsys, full_precision_scores, override):
    """int8 serving, which this test once held to raising, on the tiny
    network in float32: one score per pair within 0.02 of the full-precision
    run's (``tests/test_quant.py:117``'s bar); ``auto`` at a threshold of
    20 000 samples routes the bucket batch of 16 000 samples in full
    precision and the two of 24 000 in int8, and prints the JAX package's
    line; ``true`` serves every batch in int8."""
    from w2v2_speaker_tpu_torch import predict as torch_predict

    capsys.readouterr()
    got = _scores(torch_predict.main(
        [*PREDICT_OVERRIDES, "data.dataloader.test_batch_size=2", "network.int8_auto_min_samples=20000",
         override, f"predict_folder_path={tmp_path}", f"pair_prediction_path={_write_folder(tmp_path)}"],
        device="cpu"))
    runs = {"full": full_precision_scores, "int8": got}
    routing = [line for line in capsys.readouterr().out.splitlines() if line.startswith("int8 auto dispatch")]
    assert routing == (["int8 auto dispatch: 2/3 bucket batches on int8 (threshold 20000 samples)"]
                       if override.endswith("auto") else [])
    assert runs["int8"][1] == runs["full"][1] and len(runs["full"][0]) == 10
    drift = np.abs(runs["int8"][0] - runs["full"][0]).max()
    assert 0 < drift < 0.02, drift


@pytest.mark.parametrize("network", ["wav2vec_fc", "wav2vec_xvector"])
def test_predict_serves_the_wav2vec1_networks(tmp_path, network):
    """The wav2vec v1 networks, which this test once held to raising,
    serve a pair file at their full width from a seeded initialisation:
    one score in [0, 1] per pair, and a rerun from the embedding cache
    gives the same scores."""
    from w2v2_speaker_tpu_torch import predict as torch_predict

    argv = [f"network={network}", "trainer.precision=f32", f"predict_folder_path={tmp_path}",
            f"pair_prediction_path={_write_folder(tmp_path)}", "data.dataloader.test_batch_size=2"]
    scores, pairs = _scores(torch_predict.main(argv, device="cpu"))
    assert len(pairs) == 10 and np.all((scores >= 0) & (scores <= 1)) and np.ptp(scores) > 0
    assert len(list((tmp_path / "embeddings").rglob("*.npy"))) == 5
    np.testing.assert_array_equal(_scores(torch_predict.main(argv, device="cpu"))[0], scores)
