"""Item 5's last options of the port against the JAX package, float32 on
the CPU at tiny widths: the backbone's hidden states (post-norm and
pre-norm layouts), layer-ensemble embeddings, the feature-encoder-only
model, the ensemble and frame-level (``[T, D]``) scorers of the cosine
evaluators, ``extract_embeddings(num_ensembles=...)``, and the predict twin
serving a multitask checkpoint.

Limits: hidden states and embeddings rtol 1e-4, atol 1e-5 (the port's
embedding limit against the reference, float32 through the encoder); the
conv-only features 2e-5 / 2e-5 (the fused conv's); scores 1e-6 and
EER / minDCF exact (``test_torch_eval.py``'s: the same float64 numpy
scoring of embeddings that agree to ~1e-7); predict score files 1e-5
(``test_torch_predict.py``'s). One layer's state swapped for its
neighbour's (``test_a_swapped_layer_state_breaks_the_limit``) reads far
above the hidden-state limit. Hidden states are compared on valid frames:
what a padded query row holds is neither package's contract (the port's
attention writes 0 there)."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict import SCORE_ATOL, _scores, _write_folder

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.data import samples as jsamples
from w2v2_speaker_tpu.data.trials import EvaluationPair as JaxPair
from w2v2_speaker_tpu.eval import evaluator as jeval
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch.data import samples as tsamples
from w2v2_speaker_tpu_torch.data.trials import EvaluationPair
from w2v2_speaker_tpu_torch.eval import evaluator as teval
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.runtime.predict import extract_embeddings

TINY = dict(  # every rate at 0
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
    num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, layerdrop=0.0, mask_time_prob=0.0,
    hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
LAYOUTS = {"post_norm": {}, "pre_norm": dict(do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True)}
N, LENGTHS = 1600, [1600, 1310, 1020, 700]
RTOL, ATOL = 1e-4, 1e-5
CONV_RTOL, CONV_ATOL = 2e-5, 2e-5
SCORE_TOL = 1e-6


def _wavs(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    return rng.normal(0, 0.5, (len(lengths), N)).astype(np.float32) * mask, mask


@functools.lru_cache(maxsize=None)
def _backbones(layout):
    """(JAX hidden states on ``_wavs(1)``, the port's) of one layout, from
    the same params, and the frame mask."""
    cfg = {**TINY, **LAYOUTS[layout]}
    jmodel = jw.Wav2Vec2Model(cfg=jw.Wav2Vec2Config(**cfg))
    wav, mask = _wavs(1)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask))["params"]
    x, frame_mask, want = jax.jit(lambda p, w, m: jmodel.apply({"params": p}, w, m, output_hidden_states=True))(
        params, jnp.asarray(wav), jnp.asarray(mask))
    tcfg = tw.Wav2Vec2Config(**cfg)
    tmodel = tw.Wav2Vec2Model(tcfg)
    tmodel.load_state_dict(params_from_jax(jax.device_get(params), tcfg), strict=True)
    with torch.no_grad():
        got_x, got_mask, got = tmodel(torch.from_numpy(wav), torch.from_numpy(mask), output_hidden_states=True)
        plain, _ = tmodel(torch.from_numpy(wav), torch.from_numpy(mask))
    frames = np.asarray(frame_mask)
    np.testing.assert_array_equal(got_mask.numpy(), frames)
    torch.testing.assert_close(got_x, plain, rtol=0, atol=0)
    assert torch.equal(got[-1], got_x)  # the last state is the output (after the final norm in pre-norm)
    return [np.asarray(h)[frames] for h in want], [h.numpy()[frames] for h in got], np.asarray(x)[frames]


def _worst_share(got, want):
    """The largest error / (ATOL + RTOL |want|) over every state."""
    return max(float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_hidden_states_match_jax(layout):
    """``num_layers + 1`` float32 states: the encoder's input, then each
    layer's output (in pre-norm the last one after the final LayerNorm)."""
    want, got, want_x = _backbones(layout)
    assert len(got) == len(want) == TINY["num_layers"] + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"state {i}")
    np.testing.assert_allclose(got[-1], want_x, rtol=RTOL, atol=ATOL)


def test_a_swapped_layer_state_breaks_the_limit():
    """The planted fault: states 1 and 2 handed back in each other's place
    read at least 100x the limit."""
    want, got, _ = _backbones("post_norm")
    assert _worst_share(got, want) <= 1
    assert _worst_share([got[0], got[2], got[1]], want) > 100


def _speaker_pair(**kw):
    jcfg = js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY), **kw)
    tcfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY), **kw)
    jmodel = js.Wav2Vec2SpeakerModel(cfg=jcfg, num_speakers=5)
    wav, mask = _wavs(0)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(wav), jnp.asarray(mask)))
    tmodel = ts.Wav2Vec2SpeakerModel(tcfg, num_speakers=5)
    tmodel.load_state_dict(params_from_jax(params["params"], tcfg, params.get("batch_stats")), strict=True)
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("pooling, test_pooling, num", [("mean", "max", 3), ("mean+std", None, 2)])
def test_ensemble_embeddings_match_jax(pooling, test_pooling, num):
    """The last ``num`` hidden states, each pooled with the training
    pooling (not the test pooling, where they differ), against JAX's
    ``compute_ensemble_embeddings``."""
    jmodel, params, tmodel = _speaker_pair(stat_pooling_type=pooling, test_stat_pooling_type=test_pooling)
    wav, mask = _wavs(2)
    want = jax.jit(lambda p, w, m: jmodel.apply(p, w, m, num_ensembles=num,
                                                 method=js.Wav2Vec2SpeakerModel.compute_ensemble_embeddings))(
        params, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel.compute_ensemble_embeddings(torch.from_numpy(wav), torch.from_numpy(mask), num)
    assert len(got) == len(want) == num
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_feature_encoder_only_matches_jax():
    """The conv stack alone: the backbone's 512-wide (here 16) float32
    features and frame mask, the pooled embedding and logits; params load
    strictly (``wav2vec2.feature_encoder.*`` only); ensembles raise."""
    jmodel, params, tmodel = _speaker_pair(feature_encoder_only=True)
    assert set(params["params"]["wav2vec2"]) == {"feature_encoder"}
    wav, mask = _wavs(3)
    want = jax.jit(lambda p, w, m: jmodel.apply(p, w, m))(params, jnp.asarray(wav), jnp.asarray(mask))
    feats, frame_mask = jax.jit(lambda p, w, m: jmodel.apply(p, w, m, method=lambda mod, w, m: mod.wav2vec2(w, m)))(
        params, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(wav), torch.from_numpy(mask))
        got_feats, got_mask = tmodel.wav2vec2(torch.from_numpy(wav), torch.from_numpy(mask))
    frames = np.asarray(frame_mask)
    np.testing.assert_array_equal(got_mask.numpy(), frames)
    assert got_feats.dtype == torch.float32 and got_feats.shape[-1] == TINY["conv_dim"][-1]
    np.testing.assert_allclose(got_feats.numpy()[frames], np.asarray(feats)[frames], rtol=CONV_RTOL, atol=CONV_ATOL)
    for key in ("embedding", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="ensembles need the transformer encoder"):
        tmodel.compute_ensemble_embeddings(torch.from_numpy(wav))


def _scored(kind, seed=0):
    """(port samples, JAX samples, port pairs, JAX pairs) of 6 utterances
    over 3 speakers: ensembles of 3 layers of [8] or frame embeddings
    [T, 8] with T 20-90 (some above the scorer's 50 frames)."""
    rng = np.random.default_rng(seed)
    embs = []
    for i in range(6):
        if kind == "ensemble":
            embs.append([rng.normal(size=8).astype(np.float32) + i % 3 for _ in range(3)])
        else:
            embs.append(rng.normal(size=(int(rng.integers(20, 90)), 8)).astype(np.float32) + i % 3)
    ids = [f"s{i % 3}/u{i}" for i in range(6)]
    trials = [(ids[i][:2] == ids[j][:2], ids[i], ids[j]) for i in range(6) for j in range(i + 1, 6)]
    return ([teval.EmbeddingSample(k, e) for k, e in zip(ids, embs)],
            [jeval.EmbeddingSample(k, e) for k, e in zip(ids, embs)],
            [EvaluationPair(*t) for t in trials], [JaxPair(*t) for t in trials])


@pytest.mark.parametrize("kind", ["ensemble", "frames"])
@pytest.mark.parametrize("evaluator", ["cosine", "centred", "asnorm"])
def test_ensemble_and_frame_scores_match_jax(kind, evaluator):
    """Scores 1e-6 and EER / minDCF exact, through ``evaluate``, for the
    plain and the centred cosine and AS-Norm (which warns and falls back to
    the cosine's dispatch in both packages)."""
    got_s, want_s, got_p, want_p = _scored(kind)

    def build(mod):
        if evaluator == "asnorm":
            e = mod.ASNormCosineEvaluator(cohort_topk=3)
            e.fit_parameters([np.full(8, i, np.float32) + np.arange(8) for i in range(5)])
            return e
        return mod.CosineDistanceEvaluator(center_before_scoring=evaluator == "centred")

    got_e, want_e = build(teval), build(jeval)
    if evaluator == "centred":
        train = [np.random.default_rng(i).normal(size=8) for i in range(5)]
        got_e.fit_parameters(train)
        want_e.fit_parameters(train)
    pairs = [(s, s2) for s, s2 in zip(got_s[:3], got_s[3:])]
    jpairs = [(s, s2) for s, s2 in zip(want_s[:3], want_s[3:])]
    def fallback():
        return pytest.warns(UserWarning, match="AS-norm") if evaluator == "asnorm" else contextlib.nullcontext()

    with fallback():
        got_scores = got_e._compute_prediction_scores(pairs)
        got = got_e.evaluate(got_p, got_s)
    with fallback():
        want_scores = want_e._compute_prediction_scores(jpairs)
        want = want_e.evaluate(want_p, want_s)
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=SCORE_TOL)
    assert got == want and 0 <= got["eer"] <= 1


def test_ensemble_scores_are_the_mean_of_each_layers_and_check_shapes():
    got_s, _, got_p, _ = _scored("ensemble")
    e = teval.CosineDistanceEvaluator()
    pairs = [(got_s[0], got_s[1]), (got_s[2], got_s[5])]
    per_layer = [e._compute_prediction_scores([(teval.EmbeddingSample(a.sample_id, a.embedding[i]),
                                                teval.EmbeddingSample(b.sample_id, b.embedding[i]))
                                               for a, b in pairs]) for i in range(3)]
    np.testing.assert_allclose(e._compute_prediction_scores(pairs), np.mean(per_layer, axis=0), rtol=0, atol=1e-12)
    short = teval.EmbeddingSample("x", got_s[1].embedding[:2])
    with pytest.raises(ValueError, match="every sample must be an ensemble of 3"):
        e._compute_prediction_scores([(got_s[0], short)])


def _extract_pair(wavs, ensemble, batch_size=2, **kw):
    """(the port's, the JAX package's) ``extract_embeddings`` of ``wavs`` on
    the same model: per-layer ensembles of 2, or ``[T, D]`` frames."""
    jmodel, params, tmodel = _speaker_pair(**kw)
    method = (functools.partial(js.Wav2Vec2SpeakerModel.compute_ensemble_embeddings, num_ensembles=2) if ensemble
              else js.Wav2Vec2SpeakerModel.compute_embedding)
    embed = jax.jit(lambda state, x, m: jmodel.apply(state, x, m, method=method))
    want = jexp.extract_embeddings(embed, params, [jsamples.SpeakerSample(f"k{i}", w, -1) for i, w in enumerate(wavs)],
                                   pad_to_multiple=800, batch_size=batch_size, ensemble=ensemble)
    got = extract_embeddings(tmodel, [tsamples.SpeakerSample(f"k{i}", w, -1) for i, w in enumerate(wavs)],
                             pad_to_multiple=800, batch_size=batch_size, device="cpu",
                             num_ensembles=2 if ensemble else None)
    return got, want


FRAMES = dict(stat_pooling_type="none", test_stat_pooling_type="none")


@pytest.mark.parametrize("ensemble", [True, False])
def test_extract_embeddings_matches_jax(ensemble):
    """Bucketed extraction of 5 utterances (the last batch padded with
    empty rows): per-layer ensembles, or (test pooling ``none``) ``[T, D]``
    frame embeddings, which hold every frame of their padded batch in both
    packages. Frames are compared where they are valid: what a padded frame
    holds is neither package's contract (the port's attention writes 0 on
    padded query rows, the JAX package's XLA path attends them to the valid
    keys)."""
    rng = np.random.default_rng(4)
    wavs = [rng.normal(0, 0.5, n).astype(np.float32) for n in (900, 1500, 700, 1300, 1100)]
    got, want = _extract_pair(wavs, ensemble, **(dict(stat_pooling_type="mean") if ensemble else FRAMES))
    assert [s.sample_id for s in got] == [s.sample_id for s in want]
    for g, w in zip(got, want):
        if ensemble:
            assert isinstance(g.embedding, list) and len(g.embedding) == len(w.embedding) == 2
            for a, b in zip(g.embedding, w.embedding):
                np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
        else:
            n = jw.feat_extract_output_lengths(len(wavs[int(g.sample_id[1:])]), jw.Wav2Vec2Config(**TINY))
            assert g.embedding.shape == np.asarray(w.embedding).shape and g.embedding.shape[0] >= n
            np.testing.assert_allclose(g.embedding[:n], np.asarray(w.embedding)[:n], rtol=RTOL, atol=ATOL)


def test_frame_scores_move_with_the_batch_padding_as_in_jax():
    """The reference's defect, kept (ROADMAP Queue 3): a ``[T, D]`` test
    embedding holds its batch's padding frames, so the frame-level scorer
    draws them too and a trial's score depends on what it was batched
    with. The short utterance batched alone, then with a longer one: as
    many frames in both packages, more of them in the longer batch, and in
    each package another score (by more than 100x the 1e-6 score limit)."""
    rng = np.random.default_rng(5)
    short, other, long_ = (rng.normal(0, 0.5, n).astype(np.float32) for n in (700, 900, 3100))
    frames, scores = {}, {}
    for name, wavs, batch in (("alone", [short, other], 1), ("with_long", [short, other, long_], 3)):
        got, want = _extract_pair(wavs, False, batch_size=batch, **FRAMES)
        frames[name] = got[0].embedding.shape[0]
        assert np.asarray(want[0].embedding).shape[0] == frames[name]
        scores[name] = {k: mod.CosineDistanceEvaluator()._non_pooled_scores([(e[0], e[1])])[0]
                        for k, e, mod in (("torch", got, teval), ("jax", want, jeval))}
    n = jw.feat_extract_output_lengths(700, jw.Wav2Vec2Config(**TINY))
    assert n <= frames["alone"] < frames["with_long"]
    for k in ("torch", "jax"):
        assert abs(scores["alone"][k] - scores["with_long"][k]) > 100 * SCORE_TOL, k


PREDICT_MT = ["network=wav2vec2_multitask", "optim/loss=ctc_ce", "network.wav2vec2_size=tiny",
              "network.explicit_vocab_size=7", "trainer.precision=f32", "data.dataloader.test_pad_to_multiple=8000",
              "data.dataloader.test_batch_size=4"]


def test_predict_serves_a_multitask_checkpoint_as_jax(tmp_path_factory):
    """The port's ``predict.main`` on a JAX multitask model's params
    (``save_params``, exported with ``tools/export_jax_params.py``) against
    the JAX package's ``predict.main``: score files within 1e-5; the
    speaker branch embeds."""
    import importlib.util
    import pathlib

    import predict as jax_predict
    from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
    from w2v2_speaker_tpu.train.checkpoint import save_params
    from w2v2_speaker_tpu_torch import predict as torch_predict

    root = pathlib.Path(__file__).resolve().parents[1]
    tmp = tmp_path_factory.mktemp("mt_ckpt")
    task, kind = jexp.build_model_and_task(jax_load_config(root / "config", "predict", PREDICT_MT), 2)
    assert kind == "multitask"
    params, _ = task.init(jax.random.PRNGKey(7), {"features": jnp.zeros((2, 16000)),
                                                  "mask": jnp.ones((2, 16000), bool)})
    save_params(tmp / "init", params)
    spec = importlib.util.spec_from_file_location("export_jax_params", root / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    export.main([str(tmp / "init"), str(tmp / "init.npz")])
    runs = {}
    for name, ckpt in (("jax", tmp / "init"), ("torch", tmp / "init.npz")):
        folder = tmp_path_factory.mktemp(name)
        argv = [*PREDICT_MT, f"predict_folder_path={folder}", f"pair_prediction_path={_write_folder(folder)}",
                f"load_network_from_checkpoint={ckpt}"]
        runs[name] = _scores(jax_predict.main(argv) if name == "jax" else torch_predict.main(argv, device="cpu"))
    (want, want_pairs), (got, got_pairs) = runs["jax"], runs["torch"]
    assert got_pairs == want_pairs and len(got) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
