"""The paired (w2v2-bce) family of the port against the JAX package's on
the CPU, at tiny geometry in float32 with every dropout and layerdrop at
0, from the same weights (``params_from_jax``): the packed
``[CLS, a, SEP, b, SEP]`` sequence and its mask, the logit, one BCE step's
loss and gradients, padding invariance of the scores,
``PairedBatchProcessor`` in both modes and ``paired_scores_to_metrics``.

Limits: packed sequence and logit 1e-5 / 1e-6 (the same math in other
summation orders); loss and gradients 5e-4 / 5e-5 (the train-step tests'
limits); padded vs unpadded scores 1e-5 / 1e-6; the sequence mask, the
batches and the metrics exactly."""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.data import batching as jbatching
from w2v2_speaker_tpu.data import samples as jsamples
from w2v2_speaker_tpu.data.trials import EvaluationPair as JaxPair
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_paired as jpm
from w2v2_speaker_tpu.train import paired_task as jtask
from w2v2_speaker_tpu_torch.data import batching as tbatching
from w2v2_speaker_tpu_torch.data import samples as tsamples
from w2v2_speaker_tpu_torch.data.trials import EvaluationPair as TorchPair
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_paired as tpm
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.train import paired_task as ttask

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
TINY = dict(
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32, num_layers=2,
    num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    layerdrop=0.0, mask_time_prob=0.0, hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
N = 1200


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, its params, the port's model) from the same weights."""
    jm = jpm.Wav2Vec2PairedModel(cfg=jpm.Wav2Vec2PairedConfig(
        w2v2=jw.Wav2Vec2Config(**TINY, attention_impl="xla"), cls_token_constant=0.5, sep_token_constant=-2.0))
    z = jnp.zeros((2, N))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3), z, z)["params"])
    cfg = tpm.Wav2Vec2PairedConfig(w2v2=tw.Wav2Vec2Config(**TINY), cls_token_constant=0.5, sep_token_constant=-2.0)
    tm = tpm.Wav2Vec2PairedModel(cfg)
    tm.load_state_dict(params_from_jax(params, cfg), strict=True)
    return jm, params, tm


def _batch(lengths_a, lengths_b, seed=0):
    rng = np.random.default_rng(seed)
    out = {"labels": (np.arange(len(lengths_a)) % 2).astype(np.int32)}
    for side, lengths in (("a", lengths_a), ("b", lengths_b)):
        mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
        out[f"features_{side}"] = rng.normal(0, 0.5, (len(lengths), N)).astype(np.float32) * mask
        if not mask.all():
            out[f"mask_{side}"] = mask
    return out


PADDED = ([N, 977, 640, 400], [700, N, 1111, 400])
UNPADDED = ([N] * 3, [N] * 3)


def _jax_sequence(jm, params, batch):
    """The sequence and mask the JAX model hands its encoder."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        if isinstance(context.module, jw.Encoder) and context.method_name == "__call__":
            seen.update(seq=np.asarray(args[0]), mask=np.asarray(kwargs["attention_mask"]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(grab):
        out = jm.apply({"params": params}, *(jnp.asarray(batch[k]) if k in batch else None
                                            for k in ("features_a", "features_b", "mask_a", "mask_b")))
    return seen["seq"], seen["mask"], np.asarray(out["logit"])


def _torch_forward(tm, batch):
    seen = {}
    hook = tm.encoder.register_forward_pre_hook(lambda m, args: seen.update(seq=args[0], mask=args[1]))
    try:
        with torch.no_grad():
            out = tm(*(torch.from_numpy(batch[k]) if k in batch else None
                       for k in ("features_a", "features_b", "mask_a", "mask_b")))
    finally:
        hook.remove()
    return seen["seq"].numpy(), seen["mask"].numpy(), out["logit"].numpy()


@pytest.mark.parametrize("lengths", [UNPADDED, PADDED], ids=["unpadded", "padded"])
def test_packed_sequence_and_logit_match_jax(lengths):
    jm, params, tm = _models()
    batch = _batch(*lengths)
    want_seq, want_mask, want_logit = _jax_sequence(jm, params, batch)
    seq, mask, logit = _torch_forward(tm, batch)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_allclose(seq, want_seq, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logit, want_logit, rtol=RTOL, atol=ATOL)
    assert seq.shape[1] == 3 + 2 * 119 and logit.shape == (len(lengths[0]), 1)


def test_bce_step_loss_and_gradients_match_jax():
    jm, params, tm = _models()
    batch = _batch(*PADDED, seed=1)
    task = jtask.PairedSpeakerTask(model=jm)
    (want_loss, aux), grads = jax.value_and_grad(task.loss_fn, has_aux=True)(
        params, {}, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0), True)
    tm.zero_grad()
    loss, taux = ttask.PairedSpeakerTask(tm).loss_fn(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL, atol=ATOL)
    assert float(taux["metrics"]["accuracy"]) == float(aux["metrics"]["accuracy"])
    assert taux["metrics"]["layers_run"] == 2
    want = params_from_jax(jax.device_get(grads), tm.cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_padded_pairs_score_as_unpadded():
    _, _, tm = _models()
    batch = _batch(*PADDED, seed=2)
    task = ttask.PairedSpeakerTask(tm)
    scores = task.score_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    for i, (na, nb) in enumerate(zip(*PADDED)):
        alone = task.score_fn({"features_a": torch.from_numpy(batch["features_a"][i:i + 1, :na]),
                               "features_b": torch.from_numpy(batch["features_b"][i:i + 1, :nb])})
        torch.testing.assert_close(scores[i:i + 1], alone, rtol=RTOL, atol=ATOL)


def _stream(cls, n_spk=6, per_spk=8, k=4, seed=0):
    """Runs of ``k`` same-speaker samples, as the k-sequential shards give."""
    rng = np.random.default_rng(seed)
    out = []
    for run in range(per_spk // k):
        for s in rng.permutation(n_spk):
            for i in range(k):
                j = run * k + i
                out.append(cls(f"id{s:02d}/yt0/{j:05d}", rng.normal(0, 1, 40 + j).astype(np.float32), int(s)))
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["keys"] == w["keys"]
        for key in g:
            if key != "keys":
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 5])
def test_generated_pair_batches_match_jax(seed):
    kw = dict(batch_size=8, max_queue_size=16, mode="generate", sequential_same_speaker_samples=4,
              pos_neg_training_batch_ratio=0.5, seed=seed)
    got = list(tbatching.PairedBatchProcessor(collate_fn=tsamples.collate_paired_batch, **kw)(
        _stream(tsamples.SpeakerSample, seed=seed)))
    want = list(jbatching.PairedBatchProcessor(collate_fn=jsamples.collate_paired_batch, **kw)(
        _stream(jsamples.SpeakerSample, seed=seed)))
    _same_batches(got, want)
    assert all(b["labels"].sum() == 4 for b in got)


def test_reproduced_pair_batches_match_jax():
    stream = _stream(tsamples.SpeakerSample)
    keys = [s.key for s in stream]
    rng = np.random.default_rng(1)
    trials = [(bool(rng.integers(2)), keys[int(i)], keys[int(j)]) for i, j in rng.integers(0, len(keys), (11, 2))]
    kw = dict(batch_size=4, max_queue_size=64, mode="reproduce", sequential_same_speaker_samples=1)
    got = list(tbatching.PairedBatchProcessor(
        collate_fn=lambda s: tsamples.collate_paired_batch(s, pad_to_multiple=16),
        pairs=[TorchPair(*t) for t in trials], **kw)(stream))
    want = list(jbatching.PairedBatchProcessor(
        collate_fn=lambda s: jsamples.collate_paired_batch(s, pad_to_multiple=16),
        pairs=[JaxPair(*t) for t in trials], **kw)(_stream(jsamples.SpeakerSample)))
    _same_batches(got, want)
    assert [len(b["labels"]) for b in got] == [4, 4, 3]


@pytest.mark.parametrize("gt, scores", [
    ([1, 0, 1, 0, 1, 1], [0.9, 0.2, 0.6, 0.7, 0.55, 0.1]),
    ([1, 1, 1], [0.3, 0.6, 0.9]),  # one class: the sentinels
    ([], []),
], ids=["scores", "one_class", "empty"])
def test_paired_scores_to_metrics_matches_jax(gt, scores):
    assert ttask.paired_scores_to_metrics(gt, scores) == jtask.paired_scores_to_metrics(gt, scores)
