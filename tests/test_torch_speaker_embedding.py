"""``compute_embedding`` of the port against the JAX package's at identical
weights: mean pooling and an FC head with one hidden layer, float32 eval
on the CPU, padded and unpadded batches."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.parallel.mesh import pad_batch_rows as jax_pad_batch_rows
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
N_SPK = 8
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
# the embedding tapped after the head's hidden layer, so the head is on the path
HEAD = dict(stat_pooling_type="mean", hidden_fc_layers_out=(24,), embedding_layer_idx=0)


@functools.lru_cache(maxsize=None)
def _models():
    jm = js.Wav2Vec2SpeakerModel(
        cfg=js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY), **HEAD),
        num_speakers=N_SPK,
    )
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.zeros((1, 1600)))
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY), **HEAD)
    tm = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=N_SPK).eval()
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"]), cfg))
    embed = jax.jit(functools.partial(jm.apply, method=js.Wav2Vec2SpeakerModel.compute_embedding))
    return embed, jax.jit(jm.apply), variables, tm


def _batch(lengths, n, seed):
    rng = np.random.default_rng(seed)
    wav = rng.normal(0, 0.5, (len(lengths), n)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return {"features": wav * mask, "mask": mask}


@pytest.mark.parametrize(
    "lengths, rows",
    [
        ([1600, 1600], 2),  # unpadded
        ([1600, 1210, 843], 3),  # ragged padding
        ([1600, 1031], 4),  # plus two all-invalid rows (pad_batch_rows)
    ],
    ids=["unpadded", "padded", "padding_rows"],
)
def test_compute_embedding_matches_jax(lengths, rows):
    embed, _, variables, tm = _models()
    batch = jax_pad_batch_rows(_batch(lengths, 1600, seed=rows), rows)
    want = np.asarray(embed(variables, jnp.asarray(batch["features"]), jnp.asarray(batch["mask"])))
    with torch.no_grad():
        got = tm.compute_embedding(
            torch.from_numpy(batch["features"]), torch.from_numpy(batch["mask"])
        ).numpy()
    assert got.shape == want.shape == (rows, 24)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for row in got[len(lengths):]:  # an all-invalid row pools to 0 -> relu(fc_0 bias)
        np.testing.assert_array_equal(row, np.maximum(tm.head.fc_0.bias.detach().numpy(), 0))


def test_forward_logits_match_jax_and_padding_invariance():
    _, apply, variables, tm = _models()
    batch = _batch([1600, 977], 1600, seed=7)
    want = apply(variables, jnp.asarray(batch["features"]), jnp.asarray(batch["mask"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(batch["features"]), torch.from_numpy(batch["mask"]))
        alone = tm.compute_embedding(torch.from_numpy(batch["features"][1:, :977]))
    for key in ("embedding", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got["embedding"][1:], alone, rtol=RTOL, atol=ATOL)


def test_unported_options_raise():
    w2v2 = tw.Wav2Vec2Config(**TINY)
    for kw in (dict(use_aam=True), dict(feature_encoder_only=True), dict(ctc_head=True),
               dict(stat_pooling_type="attentive"), dict(test_stat_pooling_type="max")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.Wav2Vec2SpeakerModel(ts.Wav2Vec2SpeakerConfig(w2v2=w2v2, **kw))
    with pytest.raises(ValueError, match="unknown pooling"):
        ts.Wav2Vec2SpeakerModel(ts.Wav2Vec2SpeakerConfig(w2v2=w2v2, stat_pooling_type="median"))
