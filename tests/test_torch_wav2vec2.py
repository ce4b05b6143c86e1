"""The port's wav2vec2 backbone against the JAX package's, at identical
weights (moved across with ``params_from_jax``), float32 eval on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models.convert import params_from_jax

RTOL, ATOL = 1e-4, 1e-5

TINY = dict(  # tests/test_wav2vec2_speaker.py's tiny geometry; k=16 is even
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
LAYOUTS = {
    "base": {},  # group norm, post-norm
    "large": dict(feat_extract_norm="layer", conv_bias=True, do_stable_layer_norm=True),
}
LENGTHS = [1600, 1130, 977]


@functools.lru_cache(maxsize=None)
def _jax_model(layout):
    """(jitted JAX apply, its variables) for one layout."""
    jm = jw.Wav2Vec2Model(cfg=jw.Wav2Vec2Config(**TINY, **LAYOUTS[layout]))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 1600)))
    return jax.jit(jm.apply), variables


def _pair(layout):
    """(jitted JAX apply, its variables, port model with the same weights)."""
    apply, variables = _jax_model(layout)
    cfg = tw.Wav2Vec2Config(**TINY, **LAYOUTS[layout])
    tm = tw.Wav2Vec2Model(cfg).eval()
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"]), cfg))
    return apply, variables, tm


def _batch(lengths, n=1600, seed=0):
    rng = np.random.default_rng(seed)
    wav = rng.normal(0, 0.5, (len(lengths), n)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return wav * mask, mask


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_backbone_matches_jax(layout, padded):
    apply, variables, tm = _pair(layout)
    wav, mask = _batch(LENGTHS if padded else [1600, 1600])
    want, want_mask = apply(variables, jnp.asarray(wav), jnp.asarray(mask) if padded else None)
    with torch.no_grad():
        got, got_mask = tm(torch.from_numpy(wav), torch.from_numpy(mask) if padded else None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if padded:
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        valid = got_mask.numpy()
    else:
        assert got_mask is None
        valid = np.ones(got.shape[:2], bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_padded_batch_reproduces_unpadded_rows(layout):
    _, _, tm = _pair(layout)
    wav, mask = _batch(LENGTHS, seed=4)
    with torch.no_grad():
        batched, frame_mask = tm(torch.from_numpy(wav), torch.from_numpy(mask))
        for i, n in enumerate(LENGTHS):
            alone, _ = tm(torch.from_numpy(wav[i : i + 1, :n]))
            t = int(frame_mask[i].sum())
            assert t == alone.shape[1]
            torch.testing.assert_close(batched[i, :t], alone[0], rtol=RTOL, atol=ATOL)


def test_feat_extract_output_lengths_matches_jax():
    for cfg_kw in ({}, TINY):
        jc, tc = jw.Wav2Vec2Config(**cfg_kw), tw.Wav2Vec2Config(**cfg_kw)
        ns = [0, 1, 9, 10, 399, 400, 16000, 48000, 1_024_000]
        for n in ns:
            assert tw.feat_extract_output_lengths(n, tc) == jw.feat_extract_output_lengths(n, jc)
        got = tw.feat_extract_output_lengths(torch.tensor(ns), tc)
        want = jw.feat_extract_output_lengths(jnp.asarray(ns), jc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tw.feat_extract_output_lengths(48000) == 149
    assert tw.feat_extract_output_lengths(0) < 0  # floor division, as in JAX


def test_config_matches_jax_fields_and_validation():
    jf = {f.name: f.default for f in dataclasses.fields(jw.Wav2Vec2Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tw.Wav2Vec2Config)}
    assert tf == jf
    assert dataclasses.asdict(tw.LARGE_CONFIG) == dataclasses.asdict(jw.LARGE_CONFIG)
    with pytest.raises(ValueError, match="remat_policy"):
        tw.Wav2Vec2Config(remat_policy="dots_nobatch")


def test_init_parameters_is_seeded():
    cfg = tw.Wav2Vec2Config(**TINY)
    a, b = tw.Wav2Vec2Model(cfg), tw.Wav2Vec2Model(cfg)
    tw.init_parameters(a, torch.Generator().manual_seed(3))
    tw.init_parameters(b, torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    pc = a.encoder.pos_conv_embed
    # weight_g starts as the per-tap norm, so the effective weight is weight_v
    torch.testing.assert_close(pc.weight(), pc.weight_v)
