"""Serving path of the port against the JAX package: bucketed extraction,
pair scores, the pair-file reader and the collate copies."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from w2v2_speaker_tpu_torch.runtime import predict as tpredict

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
    want_emb, got_emb = _embeddings()
    keys = sorted(want_emb)
    pairs = [(a, b) for a in keys for b in keys if a < b]
    evaluator = CosineDistanceEvaluator()
    raw = evaluator._compute_prediction_scores(
        [(JaxEmbedding(a, want_emb[a]), JaxEmbedding(b, want_emb[b])) for a, b in pairs]
    )
    want = np.clip((np.asarray(raw) + 1) / 2, 0, 1)  # runtime/predict.py:180
    got = tpredict.score_pairs(got_emb, pairs)
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
