"""The port's audio path (``data/io.py``, ``utils/flac.py``,
``data/normalize.py``) against the JAX package's: WAV (PCM8/16/32, mono and
stereo) and FLAC (written by the JAX package's ``utils/flac_encode.py``:
fixed, LPC and verbatim subframes, stereo decorrelation modes, 8/16/24
bits) decode bit for bit the same; the normalisers agree to the last bit;
the 16 kHz and NaN / inf guards raise alike. The FLAC decoder is the
repository's ``native/flac.cpp``, compiled by the port into ``build/``."""

import wave

import numpy as np
import pytest

from w2v2_speaker_tpu.data import io as jio
from w2v2_speaker_tpu.data import normalize as jnorm
from w2v2_speaker_tpu.utils import flac as jflac
from w2v2_speaker_tpu.utils.flac_encode import encode_flac
from w2v2_speaker_tpu_torch.data import io as tio
from w2v2_speaker_tpu_torch.data import normalize as tnorm
from w2v2_speaker_tpu_torch.utils import flac as tflac


def _speechy(n=20011, seed=0, amp=3000):
    rng = np.random.default_rng(seed)
    x = amp * np.sin(np.arange(n) * 0.03) + rng.normal(0, amp / 4, n)
    return np.clip(x, -32768, 32767).astype(np.int32)


def _write_pcm(path, pcm, width, channels=1, rate=16000):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width, channels", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_wav_matches_jax_bit_for_bit(tmp_path, width, channels):
    rng = np.random.default_rng(width * 10 + channels)
    dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(dtype))
    pcm = rng.integers(info.min, info.max, (8000, channels), endpoint=True).astype(dtype)
    _write_pcm(tmp_path / "a.wav", pcm, width, channels)
    got, sr = tio.read_audio(tmp_path / "a.wav")
    want, want_sr = jio.read_audio(tmp_path / "a.wav")
    assert sr == want_sr == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.load_raw_audio(tmp_path / "a.wav"), jio.load_raw_audio(tmp_path / "a.wav"))


def test_write_wav_matches_jax(tmp_path):
    wav = np.random.default_rng(0).uniform(-1.2, 1.2, 4001).astype(np.float32)
    tio.write_wav(tmp_path / "t.wav", wav, 16000)
    jio.write_wav(tmp_path / "j.wav", wav, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("kw", [
    {}, {"force_subframe": "verbatim"}, {"force_subframe": "lpc", "lpc_order": 12},
    {"lpc_order": 0, "partition_order": 4}, {"blocksize": 512, "use_wasted_bits": True},
    {"bps": 24}, {"bps": 8},
    {"stereo": "left_side"}, {"stereo": "mid_side"},
])
def test_flac_matches_jax_bit_for_bit(tmp_path, kw):
    kw = dict(kw)
    x = _speechy()
    if kw.get("bps") == 24:
        x = (x.astype(np.int64) * 200).astype(np.int32)
    elif kw.get("bps") == 8:
        x = np.clip(x // 256, -128, 127).astype(np.int32)
    elif kw.get("use_wasted_bits"):
        x = (x >> 2) << 2
    stereo = kw.pop("stereo", None)
    if stereo:
        x = np.stack([x, np.roll(x, 3) + 17], 1).astype(np.int32)
        kw["stereo_mode"] = stereo
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(x, **kw))
    for dtype in (np.int32, np.float32):
        got, sr = tflac.read_flac(path, dtype=dtype)
        want, want_sr = jflac.read_flac(path, dtype=dtype)
        assert sr == want_sr == 16000 and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tflac.read_flac(path, dtype=np.int32)[0], x)
    np.testing.assert_array_equal(tio.read_audio(path)[0], jio.read_audio(path)[0])


def test_flac_decoder_builds_into_build_and_errors_match(tmp_path):
    assert tflac.library_path().parent == tflac.BUILD_DIR and tflac.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    tflac.load()
    assert tflac.library_path().exists()
    (tmp_path / "bad.flac").write_bytes(b"fLaX" + bytes(64))
    with pytest.raises(ValueError, match="bad magic"):
        tflac.read_flac(tmp_path / "bad.flac")
    with pytest.raises(ValueError, match="bad magic"):
        jflac.read_flac(tmp_path / "bad.flac")


def test_flac_build_failure_raises_without_fallback(tmp_path, monkeypatch):
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(_speechy(2000)))
    monkeypatch.setattr(tflac, "_lib", None)
    monkeypatch.setattr(tflac, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the FLAC decoder"):
        tio.read_audio(path)


def test_sample_rate_and_non_finite_guards(tmp_path):
    _write_pcm(tmp_path / "8k.wav", np.zeros(800, "<i2"), 2, rate=8000)
    for io in (tio, jio):
        with pytest.raises(ValueError, match="sample rate 8000 != expected 16000"):
            io.load_raw_audio(tmp_path / "8k.wav")
        for bad in (np.nan, np.inf):
            with pytest.raises(ValueError, match="NaN or inf"):
                io.guard_finite(np.array([0.0, bad], np.float32), "x")
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(_speechy(2000), sample_rate=22050))
    with pytest.raises(ValueError, match="sample rate 22050"):
        tio.load_raw_audio(path)


@pytest.mark.parametrize("channel_wise", [True, False])
def test_normalizers_match_jax(channel_wise):
    rng = np.random.default_rng(4)
    wav = (3 + 0.5 * rng.normal(size=16007)).astype(np.float32)
    np.testing.assert_array_equal(tnorm.normalize_waveform(wav), jnorm.normalize_waveform(wav))
    spec = rng.normal(size=(97, 40)).astype(np.float32) * np.arange(1, 41)
    for got, want in zip(tnorm.normalize_2d(spec, channel_wise), jnorm.normalize_2d(spec, channel_wise)):
        np.testing.assert_array_equal(got, want)
    for fn in (tnorm.normalize_waveform, jnorm.normalize_waveform):
        with pytest.raises(ValueError, match="1-D"):
            fn(spec)
    with pytest.raises(ValueError, match="2-D"):
        tnorm.normalize_2d(wav)
