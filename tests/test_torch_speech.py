"""The speech (CTC) slice of the port against the JAX package, float32 on
the CPU at tiny widths: the tokenizer, the WER, the CTC loss and its
gradient, the tri-stage schedule, the embedding masker, the speech model's
logits and the frame-level speaker logits, and one CTC training step of
``SpeechTask`` and of the ``speaker_ctc`` and ``ce_no_pool`` modes.

Limits: tokenizer, WER and masks exact; CTC loss and gradient 1e-5 / 1e-6
(rtol / atol) on feasible rows; schedule rel 1e-6 (the JAX schedule
computes in float32); logits rtol 1e-5, atol 1e-6 of the largest logit
(float32 through two layers reads ~4e-7 of it); a step's loss rel 1e-5 and its
gradients 5e-4 / 5e-5, as the other step tests, the atol times the
parameter's largest gradient where that exceeds 1: at random init the CTC
loss is ~70 a token and the head's gradients reach ~20, and float32 CTC
(optax or torch) sits ~5e-4 from a float64 CTC on the head's bias summed
over 600 frames, so the two packages differ by up to ~2e-4 there. The one
deliberate
divergence: a row whose frames are too few for its label scores 0 in the
port (``zero_infinity``) and >= 1e4 / L in the JAX package (optax's finite
``log_epsilon``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from w2v2_speaker_tpu.eval.metrics import calculate_wer as jax_wer
from w2v2_speaker_tpu.models import masking as jmask
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.models import wav2vec2_speech as jsp
from w2v2_speaker_tpu.objectives import losses as jlosses
from w2v2_speaker_tpu.objectives import schedules as jschedules
from w2v2_speaker_tpu.train import speaker_task as jtask
from w2v2_speaker_tpu.train import speech_task as jspeech
from w2v2_speaker_tpu_torch.data.tokenizer import CharTokenizer
from w2v2_speaker_tpu_torch.eval.metrics import calculate_wer
from w2v2_speaker_tpu_torch.models import masking as tmask
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models import wav2vec2_speech as tsp
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.objectives import losses as tlosses
from w2v2_speaker_tpu_torch.objectives import schedules as tschedules
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train import speaker_task as ttask
from w2v2_speaker_tpu_torch.train import speech_task as tspeech
from w2v2_speaker_tpu_torch.train import state as tstate
from w2v2_speaker_tpu_torch.train import steps as tsteps

TINY = dict(  # every rate at 0
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
    num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, layerdrop=0.0, mask_time_prob=0.0,
    hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
N, LENGTHS, N_SPK = 1600, [1600, 1310, 1020, 700], 6
TEXTS = ["THE CAT", "A DOG'S DAY", "ON IT", "X"]
VOCAB = CharTokenizer.build(TEXTS).vocab
CTC_RTOL, CTC_ATOL = 1e-5, 1e-6
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 5e-5


def _words(rng, n):
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ'"))
    return " ".join("".join(rng.choice(letters, rng.integers(1, 7))) for _ in range(n))


# ----------------------------------------------------------- tokenizer, WER


def test_tokenizer_matches_jax():
    rng = np.random.default_rng(0)
    corpus = [_words(rng, 5) for _ in range(20)]
    for got, want in ((CharTokenizer.build(corpus), JaxTokenizer.build(corpus)),
                      (CharTokenizer.wav2vec2_base_960h(), JaxTokenizer.wav2vec2_base_960h())):
        assert got.vocab == want.vocab and got.vocab_size == want.vocab_size
        for text in [*corpus[:5], "lower case?", "  two  spaces "]:
            ids = got.encode(text)
            np.testing.assert_array_equal(ids, want.encode(text))
            assert ids.dtype == np.int32
            assert got.decode(ids, ctc=False) == want.decode(ids, ctc=False)
        ids = rng.integers(0, got.vocab_size, 200)
        assert got.decode(ids) == want.decode(ids) and got.decode(ids, ctc=False) == want.decode(ids, ctc=False)
        logits = rng.normal(size=(4, 30, got.vocab_size)).astype(np.float32)
        lengths = np.array([30, 17, 1, 0])
        assert got.decode_batch(logits, lengths) == want.decode_batch(logits, lengths)
    tok = CharTokenizer.build(corpus)
    assert tok.decode(tok.encode(corpus[3]), ctc=False) == corpus[3]
    assert CharTokenizer.wav2vec2_base_960h().decode([0, 1, 8, 8, 0, 8, 4, 4, 9, 2]) == "OO N"


def test_tokenizer_save_load(tmp_path):
    tok = CharTokenizer.build(["hello world"])
    tok.save(tmp_path / "vocab.json")
    assert CharTokenizer.load(tmp_path / "vocab.json").vocab == JaxTokenizer.load(tmp_path / "vocab.json").vocab
    with pytest.raises(ValueError, match="CTC blank"):
        CharTokenizer({"a": 0, "<pad>": 1})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    refs = [_words(rng, int(rng.integers(1, 12))) for _ in range(10)]
    hyps = []
    for ref in refs:
        words = ref.split()
        for _ in range(int(rng.integers(0, 4))):  # a substitution, insertion or deletion
            i, op = int(rng.integers(0, len(words) + 1)), int(rng.integers(0, 3))
            if op == 0 and i < len(words):
                words[i] = "Z"
            elif op == 1:
                words.insert(i, "Q")
            elif words:
                words.pop(min(i, len(words) - 1))
        hyps.append(" ".join(words))
    assert calculate_wer(hyps, refs) == jax_wer(hyps, refs)
    assert calculate_wer(hyps[0], refs[0]) == jax_wer(hyps[0], refs[0])
    assert calculate_wer("", "a b") == 1.0 and calculate_wer("a b c", "a b") == 0.5
    with pytest.raises(ValueError):
        calculate_wer(["a"], [""])


# ------------------------------------------------------------------- CTC


def _ctc_inputs(seed, b=4, t=40, v=12, logit_lengths=(40, 33, 20, 12), label_lengths=(9, 5, 7, 0)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, t, v)).astype(np.float32)
    labels = np.zeros((b, 16), np.int32)
    for i, n in enumerate(label_lengths):
        labels[i, :n] = rng.integers(1, v, n)
    return logits, np.asarray(logit_lengths, np.int32), labels, np.asarray(label_lengths, np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradient_match_jax(seed):
    """Feasible rows (frames >= label + repeats) and an empty-label row,
    which both leave out of the mean."""
    logits, lens, labels, label_lens = _ctc_inputs(seed)
    want, want_grad = jax.value_and_grad(jlosses.ctc_loss)(jnp.asarray(logits), lens, labels, label_lens)
    x = torch.from_numpy(logits).requires_grad_()
    got = tlosses.ctc_loss(x, torch.from_numpy(lens), torch.from_numpy(labels), torch.from_numpy(label_lens))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=CTC_RTOL, atol=CTC_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=CTC_RTOL, atol=CTC_ATOL)


def test_ctc_infeasible_row_diverges_as_documented():
    """Row 1 has 3 frames for a label of 5: the port scores it 0 (and no
    gradient) as ``zero_infinity`` promises; the JAX package's optax CTC
    scores it ~1e5 / L, which its ``isfinite`` test lets through. Row 0
    agrees."""
    logits, lens, labels, label_lens = _ctc_inputs(3, b=2, logit_lengths=(40, 3), label_lengths=(9, 5))
    per_row = []
    for i in range(2):
        sl = slice(i, i + 1)
        x = torch.from_numpy(logits[sl]).requires_grad_()
        got = tlosses.ctc_loss(x, torch.from_numpy(lens[sl]), torch.from_numpy(labels[sl]),
                               torch.from_numpy(label_lens[sl]))
        got.backward()
        want = float(jlosses.ctc_loss(jnp.asarray(logits[sl]), lens[sl], labels[sl], label_lens[sl]))
        per_row.append((got.item(), want, float(x.grad.abs().max())))
    (feasible, feasible_jax, _), (infeasible, infeasible_jax, infeasible_grad) = per_row
    np.testing.assert_allclose(feasible, feasible_jax, rtol=CTC_RTOL)
    assert infeasible == 0.0 and infeasible_grad == 0.0
    assert infeasible_jax >= 1e4 / label_lens[1]
    both = tlosses.ctc_loss(torch.from_numpy(logits), torch.from_numpy(lens), torch.from_numpy(labels),
                            torch.from_numpy(label_lens))
    np.testing.assert_allclose(both.item(), feasible / 2, rtol=CTC_RTOL)


# ------------------------------------------------------------ schedule


@pytest.mark.parametrize("ratios", [(0.1, 0.4, 0.5), (0.3, 0.0, 0.7), (0.0, 0.0, 1.0)])
def test_tri_stage_matches_jax(ratios):
    args = (50, *ratios, 1e-7, 1e-4, 1e-6)  # the speech recipe's initial and final lr
    want, got = jschedules.tri_stage(*args), tschedules.tri_stage(*args)
    for step in range(0, 56):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=0), step
    with pytest.raises(ValueError, match="add up to 1"):
        tschedules.tri_stage(50, 0.5, 0.5, 0.5, 1e-7, 1e-4, 1e-6)


@pytest.mark.parametrize("total", [2, 3])
def test_one_cycle_below_one_warmup_step_diverges_as_documented(total):
    """With ``int(0.3 * total)`` = 0 the JAX package's one-cycle rate
    (optax's) is NaN at every step (its first phase has zero length); the
    port's starts at the peak and stays finite. At 4 steps they agree."""
    want, got = jschedules.one_cycle(9e-5, total), tschedules.one_cycle(9e-5, total)
    assert all(np.isnan(float(want(s))) for s in range(total + 1))
    assert got(0) == 9e-5 and all(np.isfinite(got(s)) and got(s) > 0 for s in range(total + 1))
    want, got = jschedules.one_cycle(9e-5, 4), tschedules.one_cycle(9e-5, 4)
    assert [got(s) for s in range(5)] == pytest.approx([float(want(s)) for s in range(5)], rel=1e-6)


def test_build_optimizer_tri_stage_and_nested_keys():
    cfg = texp.load_recipe("speech_wav2vec2_ctc", ["trainer.max_steps=50"])
    tx = texp.build_optimizer(cfg)
    want = jschedules.tri_stage(50, 0.1, 0.4, 0.5, 1e-7, 1e-4, 1e-6)
    assert [tx.schedule(s) for s in (0, 3, 10, 30, 50)] == pytest.approx(
        [float(want(s)) for s in (0, 3, 10, 30, 50)], rel=1e-6)
    nested = texp.load_recipe("speech_wav2vec2_ctc", [
        "trainer.max_steps=50", "+optim.schedule.scheduler.lr_lambda.initial_lr=1e-5"])
    assert texp.build_optimizer(nested).schedule(0) == pytest.approx(1e-5)


# ------------------------------------------------------------- masking


@pytest.mark.parametrize("probs", [(0.2, 3, 0.0, 1), (0.0, 1, 0.3, 2), (0.15, 2, 0.25, 4)])
def test_embedding_mask_with_the_same_draws_matches_jax(probs):
    """The JAX package's uniforms (its key split into time and channel
    draws) handed to the port: the same masked embeddings, exactly."""
    x = np.random.default_rng(4).normal(size=(3, 50, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jmask.embedding_mask(key, jnp.asarray(x), *probs))
    t_rng, c_rng = jax.random.split(key)
    uniforms = [torch.tensor(np.asarray(jax.random.uniform(r, (n,)))) for r, n in ((t_rng, 50), (c_rng, 24))]
    got = tmask.embedding_mask(torch.from_numpy(x), *probs, uniforms=uniforms).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()
    drops = np.asarray(jax.random.uniform(t_rng, (50,))) <= 0.2
    np.testing.assert_array_equal(tmask.expand_mask_width(torch.from_numpy(drops), 4).numpy(),
                                  np.asarray(jmask.expand_mask_width(jnp.asarray(drops), 4)))


def test_embedding_mask_draws_from_the_generator():
    x = torch.ones(2, 40, 16)
    a = tmask.embedding_mask(x, 0.2, 2, 0.2, 2, torch.Generator().manual_seed(3))
    b = tmask.embedding_mask(x, 0.2, 2, 0.2, 2, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.equal(a[0], a[1]) and (a == 0).any() and (a == 1).any()
    assert tmask.embedding_mask(x, 0.0, 1, 0.0, 1) is x


# --------------------------------------------------------------- models


def _wavs(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    return (rng.normal(0, 0.5, (len(lengths), N)).astype(np.float32) * mask), mask


def _speech_cfgs(vocab=len(VOCAB), **kw):
    return (jsp.Wav2Vec2SpeechConfig(w2v2=jw.Wav2Vec2Config(**TINY), vocab_size=vocab, head_dropout=0.0, **kw),
            tsp.Wav2Vec2SpeechConfig(w2v2=tw.Wav2Vec2Config(**TINY), vocab_size=vocab, head_dropout=0.0, **kw))


def _speaker_cfgs(**kw):
    return (js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY), **kw),
            ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY), **kw))


def _jax_eval(jmodel, params, wav, mask):
    return jax.jit(functools.partial(jmodel.apply, train=False))({"params": params}, jnp.asarray(wav),
                                                                  jnp.asarray(mask))


@functools.lru_cache(maxsize=None)
def _models(kind: str):
    """(JAX model, its params, the port's model with those weights loaded
    strictly) for "speech", "speaker_ctc", "ce_no_pool"."""
    wav, mask = _wavs(0)
    if kind == "speech":
        jcfg, tcfg = _speech_cfgs()
        jmodel, tmodel = jsp.Wav2Vec2SpeechModel(cfg=jcfg), tsp.Wav2Vec2SpeechModel(tcfg)
    else:
        ctc = kind == "speaker_ctc"
        jcfg, tcfg = _speaker_cfgs(stat_pooling_type="none", test_stat_pooling_type="mean" if ctc else None,
                                   ctc_head=ctc, ctc_blank_bias=100.0 if ctc else 0.0)
        jmodel = js.Wav2Vec2SpeakerModel(cfg=jcfg, num_speakers=N_SPK)
        tmodel = ts.Wav2Vec2SpeakerModel(tcfg, num_speakers=N_SPK)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask))["params"])
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("kind", ["speech", "speaker_ctc", "ce_no_pool"])
def test_frame_logits_match_jax(kind):
    """Eval logits of the valid frames ([B, T, V]; the speaker models with
    the pooling ``none``), the frame mask, and for ``speaker_ctc`` (test
    pooling mean) the pooled test embedding."""
    jmodel, params, tmodel = _models(kind)
    wav, mask = _wavs(1)
    t_wav, t_mask = torch.from_numpy(wav), torch.from_numpy(mask)
    if kind == "speaker_ctc":  # eval pools: the frame path is training's
        want = _jax_eval(jmodel, params, wav, mask)
        with torch.no_grad():
            got = tmodel(t_wav, t_mask)
        want_emb = np.asarray(want["embedding"])
        np.testing.assert_allclose(got["embedding"].numpy(), want_emb, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL * np.abs(want_emb).max())
        assert got["logits"].shape == (4, N_SPK + 1)
        jmodel = js.Wav2Vec2SpeakerModel(cfg=jmodel.cfg.__class__(**{**jmodel.cfg.__dict__,
                                                                    "test_stat_pooling_type": None}),
                                         num_speakers=N_SPK)
        tmodel = ts.Wav2Vec2SpeakerModel(ts.Wav2Vec2SpeakerConfig(**{**tmodel.cfg.__dict__,
                                                                    "test_stat_pooling_type": None}),
                                         num_speakers=N_SPK)
        tmodel.load_state_dict(params_from_jax(params, tmodel.cfg), strict=True)
    want = _jax_eval(jmodel, params, wav, mask)
    with torch.no_grad():
        got = tmodel(t_wav, t_mask)
    frames = np.asarray(want["frame_mask"])  # what a padded frame holds is neither package's contract
    np.testing.assert_array_equal(got["frame_mask"].numpy(), frames)
    want_logits = np.asarray(want["logits"])[frames]
    np.testing.assert_allclose(got["logits"].numpy()[frames], want_logits, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(want_logits).max())
    assert got["logits"].dtype == torch.float32 and got["logits"].ndim == 3
    if kind == "speaker_ctc":  # the blank's bias set at init
        assert params["head"]["fc_out"]["bias"][0] == 100.0
        fresh = ts.Wav2Vec2SpeakerModel(tmodel.cfg, num_speakers=N_SPK)
        tw.init_parameters(fresh, torch.Generator().manual_seed(0))
        assert fresh.head.fc_out.bias[0].item() == 100.0 and not fresh.head.fc_out.bias[1:].any()


@pytest.mark.parametrize("kind, field", [("speech", "timestep_mask_prob"), ("speech", "channel_mask_prob"),
                                         ("speaker", "final_channel_mask_prob")])
def test_masks_at_probability_one_match_jax(kind, field):
    """A drop probability of 1 masks every step (or channel) whatever the
    draws: the training forward of both packages gives the same logits."""
    wav, mask = _wavs(2)
    if kind == "speech":
        jcfg, tcfg = _speech_cfgs(**{field: 1.0})
        jmodel, tmodel = jsp.Wav2Vec2SpeechModel(cfg=jcfg), tsp.Wav2Vec2SpeechModel(tcfg)
    else:
        jcfg, tcfg = _speaker_cfgs(**{field: 1.0, "final_channel_mask_width": 2})
        jmodel = js.Wav2Vec2SpeakerModel(cfg=jcfg, num_speakers=N_SPK)
        tmodel = ts.Wav2Vec2SpeakerModel(tcfg, num_speakers=N_SPK)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(wav), jnp.asarray(mask))["params"])
    tmodel.load_state_dict(params_from_jax(params, tcfg), strict=True)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("dropout", "masking", "layerdrop", "pooling"))}
    want = jax.jit(functools.partial(jmodel.apply, train=True))(
        {"params": params}, jnp.asarray(wav), jnp.asarray(mask), rngs=rngs)
    got = tmodel(torch.from_numpy(wav), torch.from_numpy(mask), train=True, generator=torch.Generator().manual_seed(1))
    want_logits = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].detach().numpy(), want_logits, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL * np.abs(want_logits).max())


# ---------------------------------------------------------- train steps


def _step_batch(kind, tok):
    wav, mask = _wavs(5)
    if kind != "speech":
        return {"features": wav, "mask": mask, "labels": np.array([0, 3, 5, 1], np.int32)}
    ids = [tok.encode(t) for t in TEXTS]
    labels = np.zeros((4, 16), np.int32)
    for i, x in enumerate(ids):
        labels[i, : len(x)] = x
    return {"features": wav, "mask": mask, "labels": labels,
            "label_lengths": np.array([len(x) for x in ids], np.int32)}


@pytest.mark.parametrize("kind", ["speech", "speaker_ctc", "ce_no_pool"])
def test_ctc_train_step_matches_jax(kind):
    """One step from the same weights: the JAX task's loss and gradient
    against the port's ``make_train_step`` (loss metric, ``.grad``)."""
    jmodel, params, _ = _models(kind)
    _, _, tmodel = _models.__wrapped__(kind)  # a model of its own: the step updates it
    tok = CharTokenizer(VOCAB)
    batch = _step_batch(kind, tok)
    jt = (jspeech.SpeechTask(model=jmodel, tokenizer=JaxTokenizer(tok.vocab)) if kind == "speech"
          else jtask.SpeakerTask(model=jmodel, mode=kind))
    want, want_grads = jax.jit(jax.value_and_grad(lambda p: jt.loss_fn(
        p, {}, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(2), train=True)[0]))(params)
    tt = tspeech.SpeechTask(tmodel, tok) if kind == "speech" else ttask.SpeakerTask(tmodel, kind)
    state = tstate.TrainState.create(tmodel, tstate.AdamTx(lambda step: 1e-3), seed=0)
    _, metrics = tsteps.make_train_step(tt)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(want)) and metrics["layers_run"] == 2
    np.testing.assert_allclose(metrics["loss"].item(), float(want), rtol=LOSS_RTOL)
    for name, g in params_from_jax(jax.device_get(want_grads), tmodel.cfg).items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(dict(tmodel.named_parameters())[name].grad.numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL * scale, err_msg=name)


def test_speech_task_transcribes_and_scores():
    _, _, model = _models("speech")
    tok = CharTokenizer(VOCAB)
    task = tspeech.SpeechTask(model, tok)
    wav, mask = _wavs(6)
    batch = {"features": wav, "mask": mask, "transcriptions": TEXTS}
    hyps = task.transcribe(batch)
    logits, lengths = task.logits_fn(torch.from_numpy(wav), torch.from_numpy(mask))
    assert hyps == tok.decode_batch(logits.numpy(), lengths.numpy()) and len(hyps) == 4
    assert lengths.tolist() == [int(tw.feat_extract_output_lengths(n, model.cfg.w2v2)) for n in LENGTHS]
    assert task.evaluate_wer([batch, batch])["wer"] == calculate_wer(hyps * 2, TEXTS * 2)
