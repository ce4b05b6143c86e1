"""The multitask family of the port (one wav2vec2 backbone under a CTC
letter head and a speaker CE or AAM head) against the JAX package, float32
on the CPU at tiny widths: the forward outputs, the AAM head's per-row
weights, padding rows out of both objectives, one ``ctc_ce`` and one
``ctc_aam`` training step, the recipe's config and what raises.

No tone or label here comes from Python's ``hash()`` (the JAX package's
multitask overfit test does, and so depends on ``PYTHONHASHSEED``).

Limits: CTC logits, embeddings and speaker logits rtol 1e-5, atol 1e-6 of
the largest value (float32 through two layers); the AAM head's loss rel
1e-6 and its predictions 1e-6; a step's loss rel 1e-5 and its gradients
5e-4 / 5e-5, the atol times the parameter's largest gradient where that
exceeds 1 (at random init the CTC loss is ~70 a token and the letter head's
gradients reach ~20: float32 CTC's own error, as in
``test_torch_speech.py``). Padding rows (``label_lengths`` 0) leave the
loss unchanged to 1e-6 relative. Dropping the AAM head's row weights (the
planted fault of ``test_dropping_the_aam_row_weights_breaks_the_limit``)
moves the padded batch's loss far beyond that."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from w2v2_speaker_tpu.models import heads as jheads
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_multitask as jmt
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu.train import multitask_task as jtask
from w2v2_speaker_tpu_torch.data.tokenizer import CharTokenizer
from w2v2_speaker_tpu_torch.models import heads as theads
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_multitask as tmt
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train import multitask_task as ttask
from w2v2_speaker_tpu_torch.train import state as tstate
from w2v2_speaker_tpu_torch.train import steps as tsteps

TINY = dict(  # every rate at 0
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
    num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, layerdrop=0.0, mask_time_prob=0.0,
    hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
N, N_SPK = 1600, 5
LENGTHS = [1600, 1310, 1020, 700]
TEXTS = ["THE CAT", "A DOG", "ON IT", "X"]
TOK = CharTokenizer.build(TEXTS)
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 5e-5
PAD_RTOL = 1e-6


def _cfgs(mode, **kw):
    common = dict(vocab_size=TOK.vocab_size, head_dropout=0.0, use_aam=mode == "aam", **kw)
    return (jmt.Wav2Vec2MultitaskConfig(w2v2=jw.Wav2Vec2Config(**TINY), **common),
            tmt.Wav2Vec2MultitaskConfig(w2v2=tw.Wav2Vec2Config(**TINY), **common))


def _batch(seed, lengths=LENGTHS, texts=TEXTS, speakers=(0, 3, 4, 1)):
    """Waveforms under ``lengths``, CTC labels of ``texts`` (an empty text
    gives a padding row: label length 0) and ``speakers``."""
    rng = np.random.default_rng(seed)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    ids = [TOK.encode(t) if t else np.zeros(0, np.int32) for t in texts]
    labels = np.zeros((len(texts), 12), np.int32)
    for i, x in enumerate(ids):
        labels[i, : len(x)] = x
    return {"features": rng.normal(0, 0.5, (len(lengths), N)).astype(np.float32) * mask, "mask": mask,
            "labels": labels, "label_lengths": np.array([len(x) for x in ids], np.int32),
            "speaker_labels": np.asarray(speakers, np.int32)}


@functools.lru_cache(maxsize=None)
def _jax(mode):
    jcfg, _ = _cfgs(mode)
    model = jmt.Wav2Vec2MultitaskModel(cfg=jcfg, num_speakers=N_SPK)
    b = _batch(0)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(b["features"]), jnp.asarray(b["mask"]))
    return model, jax.device_get(params["params"])


def _torch(mode):
    _, tcfg = _cfgs(mode)
    model = tmt.Wav2Vec2MultitaskModel(tcfg, num_speakers=N_SPK)
    model.load_state_dict(params_from_jax(_jax(mode)[1], tcfg), strict=True)
    return model


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL * np.abs(want).max(), err_msg=err_msg)


@pytest.mark.parametrize("mode", ["ce", "aam"])
def test_forward_matches_jax(mode):
    """Eval outputs from the same params: CTC logits on the valid frames,
    the frame mask, the embedding, the speaker logits (None under AAM), the
    AAM loss and predictions with labels, and ``compute_embedding``."""
    jmodel, params = _jax(mode)
    tmodel = _torch(mode)
    b = _batch(1)
    labels = jnp.asarray(b["speaker_labels"]) if mode == "aam" else None
    want, want_emb = jax.jit(lambda p, x, m: (
        jmodel.apply({"params": p}, x, m, labels=labels),
        jmodel.apply({"params": p}, x, m, method=jmt.Wav2Vec2MultitaskModel.compute_embedding),
    ))(params, jnp.asarray(b["features"]), jnp.asarray(b["mask"]))
    t_kw = {"labels": torch.from_numpy(b["speaker_labels"])} if mode == "aam" else {}
    with torch.no_grad():
        got = tmodel(torch.from_numpy(b["features"]), torch.from_numpy(b["mask"]), **t_kw)
        got_emb = tmodel.compute_embedding(torch.from_numpy(b["features"]), torch.from_numpy(b["mask"]))
    frames = np.asarray(want["frame_mask"])
    np.testing.assert_array_equal(got["frame_mask"].numpy(), frames)
    assert got["ctc_logits"].dtype == torch.float32
    _close(got["ctc_logits"].numpy()[frames], np.asarray(want["ctc_logits"])[frames], "ctc_logits")
    _close(got["embedding"].numpy(), want["embedding"], "embedding")
    _close(got_emb.numpy(), want_emb, "compute_embedding")
    if mode == "ce":
        _close(got["logits"].numpy(), want["logits"], "logits")
    else:
        assert got["logits"] is None and want["logits"] is None
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-6)
        np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want["preds"]), rtol=0, atol=1e-6)


def _aam_pair(weights):
    """The JAX and the port's AAM heads from the same params on one batch
    with a padding row: (JAX (loss, preds), port (loss, preds))."""
    rng = np.random.default_rng(2)
    emb, labels = rng.normal(size=(5, 8)).astype(np.float32), np.array([0, 2, 1, 3, 0], np.int32)
    jhead = jheads.AAMSoftmaxHead(num_classes=4)
    params = jhead.init(jax.random.PRNGKey(1), jnp.asarray(emb))
    want = jhead.apply(params, jnp.asarray(emb), jnp.asarray(labels), jnp.asarray(weights))
    thead = theads.AAMSoftmaxHead(8, 4)
    thead.weights.data = torch.from_numpy(np.array(params["params"]["weights"]))
    got = thead(torch.from_numpy(emb), torch.from_numpy(labels), torch.from_numpy(weights))
    return want, got


def test_aam_row_weights_match_jax():
    """The per-row weights turn the AAM loss into a weighted mean; a row of
    weight 0 leaves it."""
    weights = np.array([1, 1, 1, 1, 0], np.float32)
    (want, want_p), (got, got_p) = _aam_pair(weights)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p), rtol=0, atol=1e-6)
    (unweighted, _), _ = _aam_pair(np.ones(5, np.float32))
    assert abs(float(unweighted) - float(want)) > 1e-3 * abs(float(want))


@pytest.mark.parametrize("mode", ["ce", "aam"])
def test_padding_rows_leave_both_losses(mode):
    """A batch with a padding row (label length 0, speaker 0) gives the
    same loss, speech and speaker parts as the batch without it, in both
    packages."""
    jmodel, params = _jax(mode)
    tmodel = _torch(mode)
    full = _batch(3, lengths=[1600, 1310, 1020, 700, 900], texts=[*TEXTS, ""], speakers=(0, 3, 4, 1, 0))
    rows = {k: v[:4] for k, v in full.items()}
    jt = jtask.MultitaskTask(model=jmodel, tokenizer=JaxTokenizer(TOK.vocab), mode=mode)
    tt = ttask.MultitaskTask(tmodel, TOK, mode=mode)
    got = {}
    for name, b in (("full", full), ("rows", rows)):
        aux = jax.jit(lambda p, jb: jt.loss_fn(p, {}, jb, jax.random.PRNGKey(0), train=False)[1]["metrics"])(
            params, jax.tree.map(jnp.asarray, b))
        with torch.no_grad():
            _, taux = tt.loss_fn({k: torch.from_numpy(v) for k, v in b.items()}, train=False)
        got[name] = ({k: float(aux[k]) for k in ("loss", "loss_speech", "loss_speaker", "accuracy")},
                     {k: float(taux["metrics"][k]) for k in ("loss", "loss_speech", "loss_speaker", "accuracy")})
    for k in ("loss", "loss_speech", "loss_speaker"):
        want = got["rows"][0][k]
        for value in (got["full"][0][k], got["full"][1][k], got["rows"][1][k]):
            np.testing.assert_allclose(value, want, rtol=PAD_RTOL, err_msg=k)
    assert got["full"][1]["accuracy"] == got["rows"][1]["accuracy"] == got["full"][0]["accuracy"]


def test_dropping_the_aam_row_weights_breaks_the_limit(monkeypatch):
    """The planted fault: the AAM head ignores its row weights. The padded
    batch's speaker loss then moves far beyond ``PAD_RTOL``."""
    tmodel = _torch("aam")
    tt = ttask.MultitaskTask(tmodel, TOK, mode="aam")
    full = _batch(3, lengths=[1600, 1310, 1020, 700, 900], texts=[*TEXTS, ""], speakers=(0, 3, 4, 1, 0))
    rows = {k: v[:4] for k, v in full.items()}

    def speaker_loss(b):
        with torch.no_grad():
            return float(tt.loss_fn({k: torch.from_numpy(v) for k, v in b.items()}, train=False)[1]["metrics"][
                "loss_speaker"])

    want = speaker_loss(rows)
    orig = theads.AAMSoftmaxHead.forward
    monkeypatch.setattr(theads.AAMSoftmaxHead, "forward",
                        lambda self, e, labels=None, weights=None: orig(self, e, labels, None))
    assert abs(speaker_loss(full) - want) / want > 1e3 * PAD_RTOL


@pytest.mark.parametrize("mode", ["ce", "aam"])
def test_multitask_train_step_matches_jax(mode):
    """One step from the same weights on a batch with a padding row: the
    JAX task's loss and gradients against the port's ``make_train_step``;
    the metrics carry both parts and the row-masked accuracy."""
    jmodel, params = _jax(mode)
    tmodel = _torch(mode)
    batch = _batch(5, lengths=[1600, 1310, 1020, 700, 900], texts=[*TEXTS, ""], speakers=(0, 3, 4, 1, 0))
    jt = jtask.MultitaskTask(model=jmodel, tokenizer=JaxTokenizer(TOK.vocab), mode=mode, speech_weight=0.7,
                             speaker_weight=1.3)
    want, want_grads = jax.jit(jax.value_and_grad(lambda p: jt.loss_fn(
        p, {}, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(2), train=True)[0]))(params)
    tt = ttask.MultitaskTask(tmodel, TOK, mode=mode, speech_weight=0.7, speaker_weight=1.3)
    state = tstate.TrainState.create(tmodel, tstate.AdamTx(lambda step: 1e-3), seed=0)
    _, metrics = tsteps.make_train_step(tt)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(want)) and metrics["layers_run"] == 2
    np.testing.assert_allclose(metrics["loss"].item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"].item(), 0.7 * metrics["loss_speech"].item()
                               + 1.3 * metrics["loss_speaker"].item(), rtol=1e-6)
    assert 0 <= metrics["accuracy"].item() <= 1
    for name, g in params_from_jax(jax.device_get(want_grads), tmodel.cfg).items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(dict(tmodel.named_parameters())[name].grad.numpy(), g.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL * scale, err_msg=name)


def test_missing_speaker_labels_raise():
    tt = ttask.MultitaskTask(_torch("ce"), TOK)
    b = _batch(0)
    del b["speaker_labels"]
    with pytest.raises(ValueError, match="speaker_labels"):
        tt.loss_fn({k: torch.from_numpy(v) for k, v in b.items()}, train=False)
    with pytest.raises(ValueError, match="unknown speaker mode"):
        ttask.MultitaskTask(_torch("ce"), TOK, mode="triplet")


@pytest.mark.parametrize("loss", ["ctc_ce", "ctc_aam"])
def test_build_model_and_task_matches_jax(loss):
    """The recipe (``+experiment=multitask_wav2vec2``, ``optim/loss``) gives
    the JAX package's model config, speaker count, mode and weights; with
    ``network.explicit_vocab_size`` and no tokenizer too (serving)."""
    cfg = texp.load_recipe("multitask_wav2vec2", [f"optim/loss={loss}", "network.wav2vec2_size=tiny",
                                                  "optim.loss.speaker_weight=0.5"])
    with torch.device("meta"):
        task, kind = texp.build_model_and_task(cfg, 7, tokenizer=TOK)
    jt, jkind = jexp.build_model_and_task(cfg, 7, tokenizer=JaxTokenizer(TOK.vocab))
    assert kind == jkind == "multitask" and task.mode == jt.mode == {"ctc_ce": "ce", "ctc_aam": "aam"}[loss]
    assert (task.speech_weight, task.speaker_weight) == (jt.speech_weight, jt.speaker_weight) == (1.0, 0.5)
    want = {k: v for k, v in jt.model.cfg.__dict__.items() if k != "w2v2"}
    assert {k: v for k, v in task.model.cfg.__dict__.items() if k != "w2v2"} == want
    assert task.model.cfg.w2v2.__dict__ == jt.model.cfg.w2v2.__dict__
    assert task.model.head.fc_out is None if loss == "ctc_aam" else task.model.head.fc_out.out_features == 7
    cfg["network"]["explicit_vocab_size"] = 9
    with torch.device("meta"):
        served, _ = texp.build_model_and_task(cfg, 7)
    assert served.model.lm_head.out_features == 9 and served.tokenizer is None


def test_build_model_and_task_raises_as_jax():
    cfg = texp.load_recipe("multitask_wav2vec2", ["network.wav2vec2_size=tiny"])
    for c, tok, match in ((cfg, None, "requires a tokenizer"),
                          ({**cfg, "optim": {**cfg["optim"], "loss": {"name": "cross_entropy"}}}, TOK,
                           "ctc_ce or ctc_aam")):
        with pytest.raises(ValueError, match=match):
            texp.build_model_and_task(c, 3, tokenizer=tok)
        with pytest.raises(ValueError, match=match):
            jexp.build_model_and_task(c, 3, tokenizer=None if tok is None else JaxTokenizer(tok.vocab))


def test_data_module_gets_speaker_labels_for_multitask(tmp_path):
    """``build_data_module`` forces ``with_speaker_labels`` for the
    multitask network (the YAML leaves it false), so every training batch
    carries ``speaker_labels``; the speech recipe's batches do not."""
    from test_torch_run_speech import write_librispeech

    dirs = write_librispeech(tmp_path / "raw")
    base = [*(f"data.module.{k}={v}" for k, v in dirs.items()), "data.dataloader.train_max_num_samples=16000",
            "data.dataloader.pad_to_multiple=3200"]
    for recipe, labelled in (("multitask_wav2vec2", True), ("speech_wav2vec2_ctc", False)):
        cfg = texp.load_recipe(recipe, [*base, f"data.module.shards_dir={tmp_path / recipe}"])
        assert not cfg["data"]["module"].get("with_speaker_labels")
        dm = texp.build_data_module(cfg)
        assert dm.cfg.with_speaker_labels is labelled
        batch = next(iter(dm.train_batches()))
        assert ("speaker_labels" in batch) is labelled
        if labelled:
            assert set(batch["speaker_labels"].tolist()) <= set(range(dm.num_speakers))


def test_zero_padding_rows_keep_aam_gradients_finite_unlike_jax():
    """A weight-0 row whose embedding is exactly 0 (a row of zero audio,
    as the JAX package pads a batch to its mesh) gives the JAX AAM head NaN
    gradients (the norm's at 0, times the weight 0), and the port's head 0:
    the deliberate divergence of ROADMAP Queue 3."""
    emb = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
    labels, weights = np.array([0, 0], np.int32), np.array([1.0, 0.0], np.float32)
    jhead = jheads.AAMSoftmaxHead(num_classes=3)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(emb))
    want = jax.grad(lambda e: jhead.apply(params, e, jnp.asarray(labels), jnp.asarray(weights))[0])(jnp.asarray(emb))
    thead = theads.AAMSoftmaxHead(3, 3)
    thead.weights.data = torch.from_numpy(np.array(params["params"]["weights"]))
    e = torch.tensor(emb, requires_grad=True)
    thead(e, torch.from_numpy(labels), torch.from_numpy(weights))[0].backward()
    assert np.isnan(np.asarray(want)[1]).all() and torch.equal(e.grad[1], torch.zeros(3))
    np.testing.assert_allclose(e.grad[0].numpy(), np.asarray(want)[0], rtol=1e-6)
