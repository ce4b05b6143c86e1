"""wav2vec v1 (``models/wav2vec1.py``) against the JAX package's on the CPU,
at the networks' own width (512 channels; the conv stack is fixed), on 3
rows of 0.5 s or less, from the same weights carried across by
``params_from_jax``:

- ``Wav2Vec1Encoder`` without and with the aggregator, unmasked and on a
  padded batch, in float32 and bfloat16 (the port under autocast);
- ``Wav2Vec1FCModel`` (mean and mean+std pooling, a hidden layer) and
  ``Wav2Vec1XVectorModel`` (a narrow TDNN): eval embeddings and logits,
  then one float32 CE training step's loss, every gradient and the
  x-vector head's running statistics;
- the recipes' configs against the JAX ``build_model_and_task``, the
  freeze of ``wav2vec_initially_frozen`` on the ``encoder``, and
  ``network.pretrained_checkpoint`` (the JAX package raises ``KeyError``,
  the port keeps the initialisation).

Limits (max abs err over max abs; each sits between the reading as built
and a planted fault's, which the ``*_catches_*`` tests read):

- float32 features and outputs 1e-4 (the same math in other summation
  orders; read 1.3e-6 at most); a norm that counts the padding frames
  reads 0.23 on the padded batch, conv 2's kernel transposed more than 1e-2;
- bfloat16 features 3e-2 (read 1.0e-2 at most: both sides round every conv
  output and norm to bfloat16 at the same places, but sum the convs in
  other orders, so a value one bfloat16 step away can cross a ReLU);
- one float32 step: the loss 1e-5 relative, every gradient 5e-4 of its
  tensor's max abs (floored at 1e-3 of the largest, for gradients that are
  0 in exact arithmetic: the conv biases before each norm), the running
  statistics 1e-4 (read 5.7e-7, 2.5e-5 and 5.4e-7 at most).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.models import wav2vec1 as jv1
from w2v2_speaker_tpu.models import xvector as jxv
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu.train.speaker_task import SpeakerTask as JaxSpeakerTask
from w2v2_speaker_tpu_torch.models import wav2vec1 as tv1
from w2v2_speaker_tpu_torch.models import xvector as txv
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.models.wav2vec2 import init_parameters
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train.speaker_task import SpeakerTask

F32_RTOL, BF16_RTOL = 1e-4, 3e-2
STEP_LIMITS = {"loss": 1e-5, "grads": 5e-4, "stats": 1e-4}
GRAD_FLOOR = 1e-3
SPEAKERS = 5
LENGTHS = (8000, 6100, 3300)
XV = dict(tdnn_channels=(16, 16, 16, 16, 32), lin_neurons=16)
ENCODERS = [(agg, masked, dtype) for agg in (False, True) for masked in (False, True)
            for dtype in ("float32", "bfloat16")]
MODELS = ("fc_mean", "fc_mean+std", "xvector")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tiny forwards and steps, as
    ``tests/test_torch_run.py``; yields the default, which ``all_threads``
    gives back to the run test (its float32 losses, held at
    ``LOSS_ATOL``, drift past it on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield n
    torch.set_num_threads(n)


@pytest.fixture
def all_threads(one_thread):
    torch.set_num_threads(one_thread)
    yield
    torch.set_num_threads(1)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    n = max(LENGTHS)
    t = np.arange(n) / 16000
    wav = rng.normal(0, 0.3, (len(LENGTHS), n)) + np.sin(2 * np.pi * rng.uniform(100, 3000, (len(LENGTHS), 1)) * t)
    mask = np.arange(n)[None, :] < np.asarray(LENGTHS)[:, None]
    return (wav * mask).astype(np.float32), mask, np.array([1, 4, 1], dtype=np.int32)


def _rel(got, want, floor=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor, 1e-12))


@functools.lru_cache(maxsize=None)
def jax_encoder(agg: bool, masked: bool, dtype: str):
    """The JAX encoder's float32 weights and its features and frame mask."""
    enc = jv1.Wav2Vec1Encoder(jv1.Wav2Vec1Config(use_aggregator=agg, dtype=dtype))
    wav, mask, _ = _batch()
    m = jnp.asarray(mask) if masked else None
    params = jax.device_get(jax.jit(enc.init)(jax.random.PRNGKey(1), jnp.asarray(wav), m))["params"]
    feats, fmask = jax.device_get(jax.jit(enc.apply)({"params": params}, jnp.asarray(wav), m))
    return params, feats, fmask


def encoder_error(agg, masked, dtype, norm_counts_padding=False):
    """max abs err / max abs of the port's features, over the valid frames."""
    params, want, want_mask = jax_encoder(agg, masked, dtype)
    enc = tv1.Wav2Vec1Encoder(tv1.Wav2Vec1Config(use_aggregator=agg, dtype=dtype))
    enc.load_state_dict(params_from_jax(params), strict=True)
    wav, mask, _ = _batch()
    real = tv1.SampleNorm.forward
    if norm_counts_padding:
        tv1.SampleNorm.forward = lambda self, x, mask=None: real(self, x, None)
    try:
        with torch.no_grad():
            got, got_mask = enc(torch.from_numpy(wav), torch.from_numpy(mask) if masked else None)
    finally:
        tv1.SampleNorm.forward = real
    assert got.dtype == torch.float32 and got.shape == want.shape
    if not masked:
        assert got_mask is None and want_mask is None
        return _rel(got, want)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    valid = want_mask[:, :, None]
    assert not np.asarray(got)[~want_mask].any()  # the padding frames are zero
    return _rel(np.asarray(got) * valid, want * valid)


@pytest.mark.parametrize("agg, masked, dtype", ENCODERS,
                         ids=[f"{'agg' if a else 'fe'}-{'masked' if m else 'full'}-{d}" for a, m, d in ENCODERS])
def test_encoder_matches_jax(agg, masked, dtype):
    limit = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert encoder_error(agg, masked, dtype) <= limit


def test_encoder_limit_catches_a_norm_over_the_padding():
    assert encoder_error(False, True, "float32", norm_counts_padding=True) > 100 * F32_RTOL


def build(name):
    """(JAX model, port model) of ``name``: the FC model at the recipe's
    default widths with a hidden layer of 32 (the embedding), or the
    x-vector model with a narrow TDNN."""
    cfg = jv1.Wav2Vec1Config()
    if name == "xvector":
        xv = jxv.XVectorConfig(in_channels=512, **XV)
        return (jv1.Wav2Vec1XVectorModel(cfg, xv, SPEAKERS),
                tv1.Wav2Vec1XVectorModel(tv1.Wav2Vec1Config(), txv.XVectorConfig(in_channels=512, **XV), SPEAKERS))
    pooling = name.split("_")[1]
    kw = dict(stat_pooling_type=pooling, hidden_fc_layers_out=(32,), embedding_layer_idx=0, num_speakers=SPEAKERS)
    return jv1.Wav2Vec1FCModel(cfg, **kw), tv1.Wav2Vec1FCModel(tv1.Wav2Vec1Config(), **kw)


def _random_stats(tree, rng):
    return {k: _random_stats(v, rng) if isinstance(v, dict) else
            (rng.normal(0, 0.2, v.shape) if k == "mean" else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def jax_model(name):
    """Weights, random eval statistics, eval outputs on batch 1, and one CE
    training step's loss, gradients and running statistics on batch 2."""
    jmodel, _ = build(name)
    wav, mask, _ = _batch()
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask)))
    params, stats = v["params"], v.get("batch_stats", {})
    eval_stats = _random_stats(stats, np.random.default_rng(0))
    wav, mask, _ = _batch(1)
    outputs = jax.device_get(jax.jit(jmodel.apply)({"params": params, "batch_stats": eval_stats},
                                                   jnp.asarray(wav), jnp.asarray(mask)))
    wav, mask, labels = _batch(2)
    batch = {"features": jnp.asarray(wav), "mask": jnp.asarray(mask), "labels": jnp.asarray(labels)}
    task = JaxSpeakerTask(model=jmodel, mode="ce")
    model_state = {"batch_stats": stats} if stats else {}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: task.loss_fn(p, model_state, batch, jax.random.PRNGKey(0), train=True), has_aux=True))(params)
    stepped = params_from_jax(jax.device_get(grads), None, jax.device_get(aux["model_state"]).get("batch_stats"))
    return params, stats, eval_stats, outputs, float(loss), stepped


def port_model(name, eval_stats=False):
    _, tmodel = build(name)
    params, stats, random_stats, *_ = jax_model(name)
    tmodel.load_state_dict(params_from_jax(params, None, random_stats if eval_stats else stats), strict=True)
    return tmodel


def step_errors(name):
    tmodel = port_model(name)
    *_, jloss, want = jax_model(name)
    wav, mask, labels = _batch(2)
    batch = {"features": torch.from_numpy(wav), "mask": torch.from_numpy(mask),
             "labels": torch.from_numpy(labels).long()}
    loss, _ = SpeakerTask(tmodel, "ce").loss_fn(batch, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    buffers = dict(tmodel.named_buffers())
    assert set(grads) | set(buffers) == set(want)
    floor = GRAD_FLOOR * max(float(want[n].abs().max()) for n in grads)
    return {"loss": _rel(float(loss.detach()), jloss),
            "grads": max(_rel(grads[n], want[n], floor) for n in grads),
            "stats": max([_rel(buffers[n], want[n]) for n in buffers], default=0.0)}


@pytest.fixture(scope="module")
def readings():
    out = {}
    for name in MODELS:
        tmodel = port_model(name, eval_stats=True)
        want = jax_model(name)[3]
        wav, mask, _ = _batch(1)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(wav), torch.from_numpy(mask))
            emb = tmodel.compute_embedding(torch.from_numpy(wav), torch.from_numpy(mask))
        errors = {k: _rel(got[k], want[k]) for k in ("embedding", "logits")}
        errors["compute_embedding"] = _rel(emb, want["embedding"])
        out[name] = (errors, step_errors(name))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_eval_forward_matches_jax(readings, name):
    errors = readings[name][0]
    assert all(err <= F32_RTOL for err in errors.values()), errors


@pytest.mark.parametrize("name", MODELS)
def test_training_step_matches_jax(readings, name):
    errors = readings[name][1]
    assert all(errors[k] <= limit for k, limit in STEP_LIMITS.items()), errors


def test_step_limit_catches_a_transposed_conv_kernel():
    """Conv 2's kernel loaded with its two 512 axes swapped (same shape)."""
    tmodel = port_model("fc_mean")
    w = tmodel.encoder.fe_conv_2.weight
    with torch.no_grad():
        w.copy_(w.transpose(0, 1).clone())
    wav, mask, _ = _batch(1)
    want = jax_model("fc_mean")[3]
    with torch.no_grad():
        got = tmodel(torch.from_numpy(wav), torch.from_numpy(mask))
    assert _rel(got["logits"], want["logits"]) > 100 * F32_RTOL


@pytest.mark.parametrize("recipe_overrides", [
    ["network=wav2vec_fc"], ["network=wav2vec_fc", "network.stat_pooling_type=mean+std",
                             "network.use_aggregation_layers=true", "trainer.precision=f32"],
    ["network=wav2vec_xvector"], ["network=wav2vec_xvector", "network.use_aggregation_layers=true"],
], ids=["fc", "fc_meanstd_agg_f32", "xvector", "xvector_agg"])
def test_recipe_models_match_jax_build_model_and_task(recipe_overrides):
    cfg = texp.load_recipe("speaker_wav2vec2_ce", recipe_overrides)
    want, want_kind = jexp.build_model_and_task(cfg, 1211)
    with torch.device("meta"):
        got, kind = texp.build_model_and_task(cfg, 1211)
    assert kind == want_kind == "speaker" and got.mode == want.mode == "ce"
    jm, tm = want.model, got.model
    assert type(tm).__name__ == type(jm).__name__
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    if isinstance(tm, tv1.Wav2Vec1XVectorModel):
        assert dataclasses.asdict(tm.head.cfg) == {k: v for k, v in dataclasses.asdict(jm.xvector).items()
                                                   if k != "dtype"} and jm.xvector.dtype == "float32"
        assert jm.num_speakers == tm.head.classifier.out.out_features == 1211
    else:
        assert (tm.head.num_hidden, tm.head.embedding_layer_idx) == (len(jm.hidden_fc_layers_out),
                                                                     jm.embedding_layer_idx)
        assert tm.head.fc_out.out_features == jm.num_speakers == 1211
    # the tree of the JAX model's parameters is the port's state_dict
    wav = jnp.zeros((1, 16000))
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), wav)
    shapes = params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), v["params"]), None,
                             jax.tree.map(lambda a: np.zeros(a.shape, np.float32), v.get("batch_stats", {})))
    assert {k: tuple(t.shape) for k, t in shapes.items()} == {k: tuple(t.shape) for k, t in tm.state_dict().items()}


def test_fc_pooling_other_than_mean_raises_as_in_jax():
    with pytest.raises(ValueError, match="'mean' and 'mean\\+std'"):
        tv1.Wav2Vec1FCModel(stat_pooling_type="max")
    cfg = texp.load_recipe("speaker_wav2vec2_ce", ["network=wav2vec_fc", "network.stat_pooling_type=max"])
    with pytest.raises(ValueError, match="'mean' and 'mean\\+std'"):
        jtask, _ = jexp.build_model_and_task(cfg, 4)
        jtask.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)))


def test_initially_frozen_freezes_the_encoder_alone():
    """``wav2vec_initially_frozen`` freezes the parameters under ``encoder``
    (the JAX predicate's top-level name), not the head."""
    cfg = texp.load_recipe("speaker_wav2vec2_ce", ["network=wav2vec_xvector", "network.wav2vec_initially_frozen=true",
                                                   "+network.num_frozen_steps=2", "trainer.precision=f32"])
    task, _ = texp.build_model_and_task(cfg, SPEAKERS)
    init_parameters(task.model, torch.Generator().manual_seed(0))
    state = texp._init_state(cfg, task)
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    wav, mask, labels = _batch(3)
    batch = {"features": torch.from_numpy(wav), "mask": torch.from_numpy(mask),
             "labels": torch.from_numpy(labels).long()}
    from w2v2_speaker_tpu_torch.train.steps import make_train_step

    state, _ = make_train_step(task)(state, batch)
    moved = {n for n, p in task.model.named_parameters() if not torch.equal(p.detach(), before[n])}
    assert moved and all(n.startswith("head.") for n in moved)
    assert any(n.startswith("encoder.") for n in before)


def test_pretrained_checkpoint_leaves_the_v1_networks_at_init_where_jax_raises(capsys):
    cfg = texp.load_recipe("speaker_wav2vec2_ce", ["network=wav2vec_fc", "network.pretrained_checkpoint=missing.pt"])
    jtask, _ = jexp.build_model_and_task(cfg, 4)
    with pytest.raises(KeyError):
        jexp._init_state(cfg, jtask, {"features": jnp.zeros((2, 4000))})
    task, _ = texp.build_model_and_task(cfg, 4)
    init_parameters(task.model, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    texp.graft_pretrained(task.model, cfg["network"])
    assert "has no wav2vec2 submodule; the checkpoint is not loaded" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in task.model.state_dict().items())


# optim.algo.lr: Adam's first update is lr x sign(gradient) for every element, and at these widths 23 of the
# 5.3 M gradient elements have float32 rounding for their sign (10 of them in the embedding bias, whose gradient
# is 0 in exact arithmetic: a leaky ReLU in its linear region, then a training BatchNorm); at the recipe's 4e-4
# the two runs' losses part by 2.4e-3 by step 4 for that alone, so the run compares at 1e-6
V1_RUN = ["network=wav2vec_xvector", "network.tdnn_channels=[16,16,16,16,32]", "network.lin_neurons=16",
          "optim.algo.lr=1e-6", "data.pipeline.chunk_length_sec=0.25"]
V1_PREDICT = [*V1_RUN, "trainer.precision=f32", "data.dataloader.test_batch_size=2",
              "data.dataloader.test_pad_to_multiple=4000"]
V1_SCORE_ATOL = 1e-5  # test_torch_predict.SCORE_ATOL


def test_xvector_run_and_predict_match_jax(tmp_path_factory, all_threads):
    """Both packages' ``run.main`` on ``network=wav2vec_xvector`` (a narrow
    TDNN, test_torch_run_families' corpus and steps on 0.25 s crops) from
    the same weights:
    per-step losses within ``LOSS_ATOL``, the same evaluations and
    objective. Then ``predict.main`` over test_torch_predict's folder on
    the JAX run's best checkpoint: the JAX package's, and the port's on
    that checkpoint exported with ``tools/export_jax_params.py``, within
    ``V1_SCORE_ATOL``. The JAX ``load_params`` restores the parameters
    alone, so its predict serves the x-vector head's BatchNorms at their
    initial statistics; the port serves a checkpoint's running statistics
    (test_torch_pooling), so it is held here on the export's parameters,
    and on the whole export against the port's own best checkpoint."""
    import importlib.util

    import predict as jax_predict
    import run as jrun

    from test_torch_predict import _scores, _write_folder
    from test_torch_run import Recorder, write_corpus
    from test_torch_run_families import LOSS_ATOL, ROOT, _export, run_overrides
    from w2v2_speaker_tpu_torch import predict as tpredict
    from w2v2_speaker_tpu_torch import run as trun

    tmp = tmp_path_factory.mktemp("v1_run")
    corpus = write_corpus(tmp)
    ckpt, npz = _export("train_eval", [*run_overrides(corpus, tmp, "none"), *V1_RUN], tmp,
                        {"features": jnp.zeros((2, 16000)), "mask": jnp.ones((2, 16000), bool)}, 5)
    monkeypatch = pytest.MonkeyPatch()
    rec = Recorder(monkeypatch)
    try:
        objectives = {"jax": jrun.main([*run_overrides(corpus, tmp / "jax", ckpt), *V1_RUN]),
                      "torch": trun.main([*run_overrides(corpus, tmp / "torch", npz), *V1_RUN], device="cpu")}
    finally:
        monkeypatch.undo()
    assert [s for s, _ in rec.steps["torch"]] == [s for s, _ in rec.steps["jax"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in rec.steps["torch"]], [v for _, v in rec.steps["jax"]],
                               rtol=0, atol=LOSS_ATOL)
    assert [(s, sorted(m)) for s, m in rec.evals["torch"]] == [(s, sorted(m)) for s, m in rec.evals["jax"]]
    assert objectives["torch"] == objectives["jax"] and 0 <= objectives["torch"] <= 1

    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    flat = export.export(tmp / "jax" / "ckpt" / "best", tmp / "best.npz")
    assert any(k.startswith("batch_stats/") for k in flat)
    np.savez(tmp / "best_params.npz", **{k: v for k, v in flat.items() if not k.startswith("batch_stats/")})
    runs = {"jax": (jax_predict.main, tmp / "jax" / "ckpt" / "best"),
            "torch_params": (tpredict.main, tmp / "best_params.npz"),
            "torch_export": (tpredict.main, tmp / "best.npz"),
            "torch_own": (tpredict.main, tmp / "torch" / "ckpt" / "best")}
    scores = {}
    for name, (main, weights) in runs.items():
        folder = tmp / f"predict_{name}"
        folder.mkdir()
        argv = [*V1_PREDICT, f"load_network_from_checkpoint={weights}", f"predict_folder_path={folder}",
                f"pair_prediction_path={_write_folder(folder)}"]
        scores[name] = _scores(main(argv) if name == "jax" else main(argv, device="cpu"))
    want, want_pairs = scores["jax"]
    assert all(pairs == want_pairs for _, pairs in scores.values()) and len(want) == 10
    np.testing.assert_allclose(scores["torch_params"][0], want, rtol=0, atol=V1_SCORE_ATOL)
    np.testing.assert_allclose(scores["torch_own"][0], scores["torch_export"][0], rtol=0, atol=V1_SCORE_ATOL)
    assert np.ptp(want) > 100 * V1_SCORE_ATOL
    assert np.abs(scores["torch_export"][0] - want).max() > 100 * V1_SCORE_ATOL  # the statistics moved
