"""The port's random-draw pieces of training against the JAX package's: the
counter-hash keep mask (bit for bit), ``HashDropout`` at an explicit seed,
and the SpecAugment span mask from the same uniforms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.models import masking as jmask
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.ops import flash_attention as jfa
from w2v2_speaker_tpu_torch.models import masking as tmask
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.ops import flash_attention as tfa

SEEDS = [0, -123456789, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape", [(1, 1, 5, 7), (2, 3, 7, 9), (3, 2, 33, 65)])
def test_keep_mask_matches_jax_bit_for_bit(shape, rate, seed):
    b, h, tq, tk = shape
    want = np.asarray(jfa.attention_dropout_keep(jnp.asarray([seed], jnp.int32), b, h, tq, tk, rate))
    got = tfa.attention_dropout_keep(seed, b, h, tq, tk, rate)
    assert got.dtype == torch.bool and got.shape == (b, h, tq, tk)
    np.testing.assert_array_equal(got.numpy(), want)
    if got.numel() > 10_000:  # a Bernoulli(1 - rate) sample: 5 sigma
        assert abs(1.0 - got.float().mean().item() - rate) < 5 * (rate * (1 - rate) / got.numel()) ** 0.5


def test_keep_threshold_and_seed_draws():
    assert tfa.keep_threshold(0.1) == int(0.1 * 2**32)
    assert tfa.keep_threshold(1.0) == 2**32 - 1
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    seeds = [tfa.draw_seed(a) for _ in range(50)]
    assert seeds == [tfa.draw_seed(b) for _ in range(50)]
    assert all(-(2**31) <= s < 2**31 - 1 for s in seeds) and len(set(seeds)) == 50


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_matches_jax_at_an_explicit_seed(dtype, monkeypatch):
    seed, rate = -123456789, 0.1
    x = np.random.default_rng(0).normal(size=(2, 7, 48)).astype(np.float32)
    # the JAX module draws its seed from its rng stream; pin it
    monkeypatch.setattr(jfa, "dropout_seed_from_rng", lambda rng: jnp.asarray([seed], jnp.int32))
    module = jw.HashDropout(rate=rate)
    xj = jnp.asarray(x, dtype)
    want = module.apply({}, xj, rngs={"dropout": jax.random.PRNGKey(0)})
    got = tw.hash_dropout(torch.from_numpy(x).to(getattr(torch, dtype)), rate, seed)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_hash_dropout_module_draws_its_seed_from_the_generator():
    x = torch.randn(2, 5, 16)
    drop = tw.HashDropout(0.3)
    assert drop(x) is x  # eval: no generator
    got = drop(x, torch.Generator().manual_seed(7))
    want = tw.hash_dropout(x, 0.3, tfa.draw_seed(torch.Generator().manual_seed(7)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tw.HashDropout(0.0)(x, torch.Generator()) is x


def test_bernoulli_route_uses_the_step_generator():
    x = torch.ones(4, 50, 64)
    drop = tw.HashDropout(0.25, use_hash=False)
    a = drop(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, drop(x, torch.Generator().manual_seed(1)), rtol=0, atol=0)
    assert not torch.equal(a, drop(x, torch.Generator().manual_seed(2)))
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1.0 / 0.75))}
    assert abs((a == 0).float().mean().item() - 0.25) < 0.02


@pytest.mark.parametrize("prob, span", [(0.05, 10), (0.3, 4)])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_span_mask_matches_jax_from_the_same_uniforms(prob, span, with_lengths):
    b, t = 4, 149
    key = jax.random.PRNGKey(11)
    lengths = np.array([149, 120, 37, 5]) if with_lengths else None
    want = jmask.sample_span_mask(
        key, b, t, prob, span, None if lengths is None else jnp.asarray(lengths)
    )
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, (b, t))))
    got = tmask.sample_span_mask(uniform, prob, span, None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()
    if with_lengths:  # no span starts where a whole span does not fit
        assert not got[3].any()
    assert not tmask.sample_span_mask(uniform, 0.0, span).any()
