"""The port's fbank (``data/features.py``) and fbank frontend
(``models/frontend.py``) against the JAX package's on the CPU, on the
same numpy-seeded waveforms: the mel matrix, ``num_frames``, the log-mel
features without and with lengths on padded rows (the valid frames of a
padded row against the JAX package's padded and the port's unpadded
computation), and the frontend's masked per-utterance normalisation.

Limits, each between the as-built reading and a planted fault's, which
the ``*_catches_*`` tests read:

- log-mel features, max abs error over the valid frames: 1e-3 (float32,
  the same three products in other summation orders; log compresses, so
  the absolute error of a log is the relative error of the power; read
  2.3e-5 at most). A periodic Hamming window reads 0.036; reflecting at
  the batch edge instead of the true end reads 2.2 on a padded row's last
  frames;
- the mel matrix: 1e-7 abs (both are the same float64 formula rounded to
  float32);
- the frontend's normalised features over the valid frames: 1e-3 abs
  (read 2.8e-5 at most), padding frames exactly 0; a biased std (ddof 0)
  reads 0.13, on the shortest row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from w2v2_speaker_tpu.data import features as jf
from w2v2_speaker_tpu.models.frontend import FbankFrontend as JaxFrontend
from w2v2_speaker_tpu_torch.data import features as tf
from w2v2_speaker_tpu_torch.models import frontend as tfront

FEAT_ATOL = 1e-3
MEL_ATOL = 1e-7
NORM_ATOL = 1e-3
LENGTHS = (16000, 11237, 4001, 1600)  # samples: 101, 71, 26 and 11 frames
CFGS = {"40": jf.FbankConfig(n_mels=40), "80": jf.FbankConfig(n_mels=80)}


def _batch(seed=0):
    """[4, 16000] noise with tones, each row zero past its length, and the
    mask."""
    rng = np.random.default_rng(seed)
    n = max(LENGTHS)
    t = np.arange(n) / 16000
    wav = rng.normal(0, 0.3, (len(LENGTHS), n)) + np.sin(2 * np.pi * rng.uniform(100, 3000, (len(LENGTHS), 1)) * t)
    mask = np.arange(n)[None, :] < np.asarray(LENGTHS)[:, None]
    return (wav * mask).astype(np.float32), mask


def _torch_cfg(cfg):
    return tf.FbankConfig(**cfg.__dict__)


def _valid_error(got, want, lengths, cfg):
    return max(float(np.abs(got[i, : jf.num_frames(n, cfg)] - want[i, : jf.num_frames(n, cfg)]).max())
               for i, n in enumerate(lengths))


def fbank_error(cfg, lengths=True):
    """Max abs error over the valid frames: the port's fbank against the
    JAX package's, both given the lengths (or, with ``lengths`` False, the
    port reflecting at the batch edge)."""
    wav, _ = _batch()
    lens = np.asarray(LENGTHS)
    want = np.asarray(jf.log_mel_filterbank(jnp.asarray(wav), cfg, lengths=jnp.asarray(lens)))
    got = tf.log_mel_filterbank(torch.from_numpy(wav), _torch_cfg(cfg),
                                lengths=torch.from_numpy(lens) if lengths else None).numpy()
    assert got.shape == want.shape == (len(LENGTHS), jf.num_frames(wav.shape[1], cfg), cfg.n_mels)
    return _valid_error(got, want, LENGTHS, cfg)


def frontend_error(cfg, ddof=1):
    """Max abs error of the frontend's normalised features over the valid
    frames (the padding frames must be exactly 0 in both); ``ddof`` 0
    plants a biased std into the port."""
    wav, mask = _batch(1)
    jax_front = JaxFrontend(inner=None, fbank=cfg)
    want, want_mask = jax_front.apply({}, jnp.asarray(wav), jnp.asarray(mask), method=JaxFrontend._features)
    front = tfront.FbankFrontend(torch.nn.Identity(), _torch_cfg(cfg))
    if ddof == 0:
        feats, fmask = _biased_features(front, wav, mask)
    else:
        feats, fmask = front.features(torch.from_numpy(wav), torch.from_numpy(mask))
    want, got = np.asarray(want), feats.numpy()
    assert np.array_equal(fmask.numpy(), np.asarray(want_mask))
    assert not got[~fmask.numpy()].any() and not want[~np.asarray(want_mask)].any()
    return _valid_error(got, want, LENGTHS, cfg)


def _biased_features(front, wav, mask):
    """The frontend with the std of ddof 0 (a planted fault)."""
    lengths = torch.from_numpy(mask).sum(-1)
    feats = tf.log_mel_filterbank(torch.from_numpy(wav), front.fbank, lengths=lengths)
    fmask = torch.arange(feats.shape[1])[None, :] < (lengths // front.fbank.hop_length + 1)[:, None]
    m = fmask.float()[:, :, None]
    n = m.sum(1, keepdim=True).clamp_min(2.0)
    mean = (feats * m).sum(1, keepdim=True) / n
    std = (((feats - mean) ** 2 * m).sum(1, keepdim=True) / n).sqrt()
    return (feats - mean) / (std + 1e-5) * m, fmask


@pytest.mark.parametrize("mels", CFGS)
def test_mel_matrix_and_frame_count_match_jax(mels):
    cfg = CFGS[mels]
    got = tf.mel_filterbank_matrix(_torch_cfg(cfg))
    assert got.dtype == np.float32 and np.abs(got - jf.mel_filterbank_matrix(cfg)).max() <= MEL_ATOL
    for n in (400, 401, 1599, 1600, 16000, 48000):
        assert tf.num_frames(n, _torch_cfg(cfg)) == jf.num_frames(n, cfg)
    uncentred = jf.FbankConfig(center=False)
    assert tf.num_frames(16000, _torch_cfg(uncentred)) == jf.num_frames(16000, uncentred) == 98


@pytest.mark.parametrize("mels", CFGS)
def test_fbank_with_lengths_matches_jax_on_padded_rows(mels):
    assert fbank_error(CFGS[mels]) <= FEAT_ATOL


def test_fbank_without_lengths_matches_jax():
    wav, _ = _batch()
    cfg = CFGS["40"]
    want = np.asarray(jf.log_mel_filterbank(jnp.asarray(wav), cfg))
    got = tf.log_mel_filterbank(torch.from_numpy(wav), _torch_cfg(cfg)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= FEAT_ATOL


def test_fbank_of_a_padded_row_equals_the_row_alone():
    """The valid frames of each padded row against the port's fbank of the
    row cut to its length (no lengths): reflection at the true end."""
    wav, _ = _batch()
    cfg = _torch_cfg(CFGS["80"])
    padded = tf.log_mel_filterbank(torch.from_numpy(wav), cfg, lengths=torch.tensor(LENGTHS)).numpy()
    for i, n in enumerate(LENGTHS):
        alone = tf.log_mel_filterbank(torch.from_numpy(wav[i : i + 1, :n]), cfg).numpy()[0]
        assert np.abs(padded[i, : len(alone)] - alone).max() <= FEAT_ATOL


@pytest.mark.parametrize("mels", CFGS)
def test_frontend_normalisation_matches_jax(mels):
    assert frontend_error(CFGS[mels]) <= NORM_ATOL


def test_frontend_without_mask_matches_jax():
    wav, _ = _batch(2)
    cfg = CFGS["40"]
    want, _ = JaxFrontend(inner=None, fbank=cfg).apply({}, jnp.asarray(wav), None, method=JaxFrontend._features)
    got, fmask = tfront.FbankFrontend(torch.nn.Identity(), _torch_cfg(cfg)).features(torch.from_numpy(wav))
    assert fmask is None and np.abs(got.numpy() - np.asarray(want)).max() <= NORM_ATOL


def test_fbank_limit_catches_a_periodic_window(monkeypatch):
    cfg = CFGS["40"]
    cos_m, sin_m, mel = tf._dft_and_mel(_torch_cfg(cfg))
    sym, per = np.hamming(cfg.win_length), np.hamming(cfg.win_length + 1)[:-1]
    ratio = (per / sym)[:, None].astype(np.float32)
    periodic = tuple(torch.from_numpy(m) for m in (cos_m * ratio, sin_m * ratio, mel))
    monkeypatch.setattr(tf, "_matrices", lambda c, device, dtype: periodic)
    assert fbank_error(cfg) > 10 * FEAT_ATOL


def test_fbank_limit_catches_reflection_at_the_batch_edge():
    assert fbank_error(CFGS["40"], lengths=False) > 100 * FEAT_ATOL


def test_frontend_limit_catches_a_biased_std():
    assert frontend_error(CFGS["40"], ddof=0) > 5 * NORM_ATOL
