"""Waveform augmentation on the host: the port's copy of
``w2v2_speaker_tpu/data/augment.py`` (:63-462), numpy and scipy only,
drawing every random number as the JAX module draws it, so both packages
give the same augmented samples at one seed.

- the DSP core: ``speed_perturb`` (:63, polyphase resampling for sox
  ``speed``), ``speed_perturb_native`` (:82), ``_firwin_kaiser``,
  ``add_noise_snr`` (:110), ``synthetic_rir`` (:125, an exponentially
  decaying noise tail for sox ``reverb``), ``band_reject`` (:167, a FIR
  band-reject for sox ``sinc``);
- the effects, each with its own ``LockedGenerator``:
  ``UniformSpeedAugment``, ``ChoiceSpeedAugment``, ``TimeDropoutAugment``,
  ``FrequencyDropoutAugment`` (mel-scale bands), ``ChoiceRandomNoiseAugment``
  (U[0, 1) noise, not zero-mean, as the reference's), ``ChoiceRirsNoiseAugment``
  (point-source noise streamed from ``pointsource_noises`` shards, tiled to
  the input's length), ``ReverbAugment`` and ``SpecAugmentTimeDomain``
  (which names itself ``speed<a>_<b>_...``);
- ``Augmenter`` (:414): the chain with the reference's stack /
  yield-intermediate / yield-unaugmented semantics and an optional
  ``capture(stage, wav)`` told every effect's output.

Like the JAX module, this one picks its DSP branch once, at import: scipy
(``resample_poly``, ``firwin`` + ``fftconvolve``, ``lfilter``) when it
imports, else the repository's C++ library (``utils/native.py``) and a
Python loop for the RIR's one-pole filter. The scipy-free band-reject
designs other taps (a normalised windowed sinc). The native branch raises
when the library cannot be built; neither branch falls back on the other.
"""

from __future__ import annotations

import pathlib
import threading
from fractions import Fraction
from typing import Iterator, List, Optional, Sequence

import numpy as np

try:
    from scipy import signal

    _HAS_SCIPY = True
except ImportError:  # a scipy-free host: the native DSP library serves
    signal = None
    _HAS_SCIPY = False

from .samples import SpeakerSample

__all__ = [
    "Augmenter", "ChoiceRandomNoiseAugment", "ChoiceRirsNoiseAugment", "ChoiceSpeedAugment",
    "FrequencyDropoutAugment", "LockedGenerator", "ReverbAugment", "SpecAugmentTimeDomain", "TimeDropoutAugment",
    "UniformSpeedAugment", "add_noise_snr", "band_reject", "speed_perturb", "speed_perturb_native", "synthetic_rir",
]


# ------------------------------------------------------------------ DSP core

def speed_perturb(wav: np.ndarray, factor: float, max_denominator: int = 100) -> np.ndarray:
    """sox ``speed f`` + ``rate sr``: play faster or slower (pitch and
    duration change), i.e. resample by 1 / ``factor``."""
    if factor == 1.0:
        return wav
    frac = Fraction(1.0 / factor).limit_denominator(max_denominator)
    if _HAS_SCIPY:
        return signal.resample_poly(wav.astype(np.float32), frac.numerator, frac.denominator).astype(np.float32)
    return speed_perturb_native(wav, frac.numerator, frac.denominator)


def speed_perturb_native(wav: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase resampling on the native library, with
    ``scipy.signal.resample_poly``'s filter design and indexing."""
    from ..utils import native

    x = wav.astype(np.float32)
    n = x.shape[0]
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _firwin_kaiser(2 * half_len + 1, 1.0 / max_rate) * up
    n_pre_pad = down - half_len % down
    h = np.concatenate([np.zeros(n_pre_pad, np.float32), h.astype(np.float32)])
    n_pre_remove = (half_len + n_pre_pad) // down
    n_out = -(-n * up // down)
    y = native.upfirdn(x, h, up, down)
    if y.shape[0] < n_pre_remove + n_out:
        raise RuntimeError(f"native upfirdn gave {y.shape[0]} samples, fewer than {n_pre_remove + n_out}")
    return y[n_pre_remove : n_pre_remove + n_out]


def _firwin_kaiser(numtaps: int, cutoff: float) -> np.ndarray:
    if _HAS_SCIPY:
        return signal.firwin(numtaps, cutoff, window=("kaiser", 5.0))
    m = np.arange(numtaps) - (numtaps - 1) / 2.0  # windowed sinc without scipy
    h = np.sinc(cutoff * m) * cutoff
    h *= np.kaiser(numtaps, 5.0)
    return h / h.sum()


def add_noise_snr(wav: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    """``noise`` added, scaled so that 10 log10(P_signal / P_noise) is
    ``snr_db``."""
    n = min(wav.shape[-1], noise.shape[-1])
    wav = wav[..., :n]
    noise = noise[..., :n]
    p_sig = np.mean(wav.astype(np.float64) ** 2) + 1e-12
    p_noise = np.mean(noise.astype(np.float64) ** 2) + 1e-12
    scale = np.sqrt(p_sig / (p_noise * 10.0 ** (snr_db / 10.0)))
    return (wav + scale * noise).astype(np.float32)


def synthetic_rir(rng, sample_rate: int, reverberance: float, damping: float, room_scale: float) -> np.ndarray:
    """A room impulse response parameterised as sox ``reverb`` (each knob
    0..100): a larger ``room_scale`` a longer tail, a higher
    ``reverberance`` more wet energy, a higher ``damping`` a lower cut of
    the tail's one-pole lowpass. ``rng`` draws the tail."""
    rt60 = 0.05 + (room_scale / 100.0) * 0.75  # 50 ms .. 0.8 s
    n = max(int(rt60 * sample_rate), 16)
    t = np.arange(n) / sample_rate
    decay = np.exp(-6.908 * t / rt60)  # -60 dB at rt60
    tail = rng.normal(size=n) * decay
    alpha = 0.1 + 0.85 * (damping / 100.0)
    if _HAS_SCIPY:
        tail = signal.lfilter([1 - alpha], [1, -alpha], tail)
    else:  # y[t] = (1 - a) x[t] + a y[t - 1]
        out = np.empty_like(tail)
        acc = 0.0
        for i in range(tail.shape[0]):
            acc = (1 - alpha) * tail[i] + alpha * acc
            out[i] = acc
        tail = out
    tail /= np.max(np.abs(tail)) + 1e-9
    wet = reverberance / 100.0
    rir = np.zeros(n, dtype=np.float32)
    rir[0] = 1.0  # the direct path
    rir += (wet * 0.6) * tail.astype(np.float32)
    return rir


def _mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_inv(m):
    return (10.0 ** (m / 2595.0) - 1.0) * 700.0


def band_reject(wav: np.ndarray, low_hz: float, high_hz: float, sample_rate: int, numtaps: int = 255) -> np.ndarray:
    """``wav`` with the band ``low_hz``-``high_hz`` rejected by a FIR filter
    (sox ``sinc high-low``); unchanged when the band is empty."""
    nyq = sample_rate / 2.0
    low = max(low_hz, 1.0)
    high = min(high_hz, nyq - 1.0)
    if high <= low:
        return wav
    if _HAS_SCIPY:
        taps = signal.firwin(numtaps, [low / nyq, high / nyq], pass_zero=True, window="hamming")
        return signal.fftconvolve(wav, taps, mode="same").astype(np.float32)
    m = np.arange(numtaps) - (numtaps - 1) / 2.0  # windowed-sinc bandstop on the native FIR
    f1, f2 = low / nyq, high / nyq
    lowpass = f1 * np.sinc(f1 * m)
    highpass = np.sinc(m) - f2 * np.sinc(f2 * m)
    taps = (lowpass + highpass) * np.hamming(numtaps)
    taps /= taps.sum()
    from ..utils import native

    return native.fir_same(wav.astype(np.float32), taps)


# ------------------------------------------------------------------ effects

class LockedGenerator:
    """A ``numpy.random.Generator`` whose every draw holds a lock, so the
    pipeline's worker threads can share one stream: draws are cheap and
    serialised, the DSP they parameterise runs in parallel."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        method = getattr(self._rng, name)

        def locked(*args, **kwargs):
            with self._lock:
                return method(*args, **kwargs)

        return locked


class _WavAugment:
    name = "augment"

    def __init__(self, sample_rate: int = 16000, seed: int = 0):
        self.sample_rate = sample_rate
        self.rng = LockedGenerator(seed)

    def process(self, wav: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class UniformSpeedAugment(_WavAugment):
    name = "uniform_speed"

    def __init__(self, sample_rate=16000, min_speed_factor=0.95, max_speed_factor=1.05, seed=0):
        super().__init__(sample_rate, seed)
        self.min_speed = min_speed_factor
        self.max_speed = max_speed_factor

    def process(self, wav):
        return speed_perturb(wav, float(self.rng.uniform(self.min_speed, self.max_speed)))


class ChoiceSpeedAugment(_WavAugment):
    name = "choice_speed"

    def __init__(self, sample_rate=16000, possible_speed_factors=(0.95, 1.0, 1.05), seed=0):
        super().__init__(sample_rate, seed)
        self.choices = list(possible_speed_factors)

    def process(self, wav):
        return speed_perturb(wav, float(self.rng.choice(self.choices)))


class TimeDropoutAugment(_WavAugment):
    """Zero ``min_drop_count``-``max_drop_count`` spans of up to
    ``max_dropout_length_seconds`` each."""

    name = "time_dropout"

    def __init__(self, sample_rate=16000, max_dropout_length_seconds=0.1, min_drop_count=1, max_drop_count=3,
                 seed=0):
        super().__init__(sample_rate, seed)
        self.max_len = max_dropout_length_seconds
        self.min_drops = min_drop_count
        self.max_drops = max_drop_count

    def process(self, wav):
        out = wav.copy()
        n = out.shape[-1]
        for _ in range(int(self.rng.integers(self.min_drops, self.max_drops + 1))):
            length = int(self.rng.uniform(0, self.max_len) * self.sample_rate)
            if length == 0 or length >= n:
                continue
            start = int(self.rng.integers(0, n - length))
            out[start : start + length] = 0.0
        return out


class FrequencyDropoutAugment(_WavAugment):
    """Reject random mel-scale bands (the reference's SpecAugmentBand): F =
    27 x ``band_scaling``, width ~ U(0, melfmax F / 256), start ~ U(0,
    melfmax - width)."""

    name = "frequency_dropout"

    def __init__(self, sample_rate=16000, min_drop_count=1, max_drop_count=3, band_scaling=1.0, seed=0):
        super().__init__(sample_rate, seed)
        self.min_drops = min_drop_count
        self.max_drops = max_drop_count
        self.scaling = band_scaling

    def process(self, wav):
        out = wav
        drops = int(self.rng.integers(self.min_drops, self.max_drops + 1))
        f_cap = 27.0 * self.scaling
        melfmax = _mel(self.sample_rate / 2)
        for _ in range(drops):
            meldf = self.rng.uniform(0, melfmax * f_cap / 256.0)
            melf0 = self.rng.uniform(0, melfmax - meldf)
            out = band_reject(out, _mel_inv(melf0), _mel_inv(melf0 + meldf), self.sample_rate)
        return out


class ChoiceRandomNoiseAugment(_WavAugment):
    """U[0, 1) noise at an SNR drawn from ``snr_choices`` (not zero-mean, as
    the reference's torch ``.uniform_()`` noise)."""

    name = "uniform_noise"

    def __init__(self, sample_rate=16000, snr_choices=(5, 10, 15, 20), seed=0):
        super().__init__(sample_rate, seed)
        self.snr_choices = list(snr_choices)

    def process(self, wav):
        noise = self.rng.random(wav.shape[-1]).astype(np.float32)
        return add_noise_snr(wav, noise, float(self.rng.choice(self.snr_choices)))


class ChoiceRirsNoiseAugment(_WavAugment):
    """Point-source noise streamed from the ``pointsource_noises`` shards of
    ``shards_folder`` (shard order shuffled from seed 0, repeated without
    end), tiled to the input's length and added at an SNR drawn from
    ``snr_choices``. The stream is read under a lock: the pipeline's worker
    threads share it (the JAX module's unlocked generator raises
    "generator already executing" when two workers read it at once)."""

    name = "rirs_background_noise"

    def __init__(self, shards_folder, sample_rate=16000, snr_choices=(5, 10, 15, 20), seed=0):
        super().__init__(sample_rate, seed)
        self.snr_choices = list(snr_choices)
        self.shards_folder = pathlib.Path(shards_folder)
        self._iter: Optional[Iterator] = None
        self._lock = threading.Lock()

    def _noise_iter(self) -> Iterator[np.ndarray]:
        from .shards import ShardReader

        paths = [p for p in self.shards_folder.iterdir() if "pointsource_noises" in p.name and ".tar" in p.name]
        if not paths:
            raise ValueError(f"no pointsource_noises shards in {self.shards_folder}")
        reader = ShardReader(paths, shuffle_shards=True, seed=0)
        while True:  # .repeat()
            for sample in reader:
                yield sample.wav

    def process(self, wav):
        with self._lock:
            if self._iter is None:
                self._iter = self._noise_iter()
            noise = next(self._iter)
        n = wav.shape[-1]
        while noise.shape[-1] < n:
            noise = np.concatenate([noise, noise])
        return add_noise_snr(wav, noise[:n], float(self.rng.choice(self.snr_choices)))


class ReverbAugment(_WavAugment):
    """``wav`` convolved with a ``synthetic_rir`` of integer knobs drawn
    from their ranges, cut to the input's length."""

    name = "add_reverb"

    def __init__(self, sample_rate=16000, reverberance_min=50, reverberance_max=50, damping_min=50,
                 damping_max=50, room_scale_min=0, room_scale_max=100, seed=0):
        super().__init__(sample_rate, seed)
        self.reverberance = (reverberance_min, reverberance_max)
        self.damping = (damping_min, damping_max)
        self.room_scale = (room_scale_min, room_scale_max)

    def process(self, wav):
        r = float(self.rng.integers(self.reverberance[0], self.reverberance[1] + 1))
        d = float(self.rng.integers(self.damping[0], self.damping[1] + 1))
        s = float(self.rng.integers(self.room_scale[0], self.room_scale[1] + 1))
        rir = synthetic_rir(self.rng, self.sample_rate, r, d, s)
        if _HAS_SCIPY:
            return signal.fftconvolve(wav, rir)[: wav.shape[-1]].astype(np.float32)
        from ..utils import native

        return native.fft_convolve(wav.astype(np.float32), rir)[: wav.shape[-1]]


class SpecAugmentTimeDomain(_WavAugment):
    """speechbrain's TimeDomainSpecAugment speed perturbation: a speed in
    percent drawn from ``speeds``."""

    name = "specaugment_time_domain"

    def __init__(self, speeds=(95, 100, 105), sample_rate=16000, seed=0):
        super().__init__(sample_rate, seed)
        self.speeds = list(speeds)
        self.name = "speed" + "_".join(str(s) for s in self.speeds)

    def process(self, wav):
        return speed_perturb(wav, float(self.rng.choice(self.speeds)) / 100.0)


# ------------------------------------------------------------------ compose

class Augmenter:
    """The effect chain over ``SpeakerSample``s. Each effect's output takes
    the key ``<key>/<effect name>``. ``stack_augmentations`` feeds each
    effect the previous one's output (else the original);
    ``yield_intermediate_augmentations`` returns every effect's output
    (else only the last); ``yield_unaugmented`` puts the original first,
    and, as in the reference, acts only with
    ``yield_intermediate_augmentations``. Stacking nothing and yielding
    nothing raises."""

    def __init__(self, augmenters: Sequence[_WavAugment], stack_augmentations: bool = True,
                 yield_intermediate_augmentations: bool = False, yield_unaugmented: bool = False):
        if not stack_augmentations and not yield_intermediate_augmentations:
            raise ValueError("augmenter must at least stack augmentations or yield intermediate augmentations")
        self.augmenters = list(augmenters)
        self.stack = stack_augmentations
        self.yield_intermediate = yield_intermediate_augmentations
        self.yield_unaugmented = yield_unaugmented

    def __call__(self, sample: SpeakerSample, capture=None) -> List[SpeakerSample]:
        """The augmented samples of ``sample``; ``capture(stage, wav)``, when
        given, is told each effect's output as ``augment_<name>``."""
        out: List[SpeakerSample] = []
        if self.yield_unaugmented:
            out.append(sample)
        current = sample
        for aug in self.augmenters:
            new = SpeakerSample(key=current.key + f"/{aug.name}", wav=aug.process(current.wav),
                                ground_truth=current.ground_truth, meta=current.meta)
            if capture is not None:
                capture(f"augment_{aug.name}", new.wav)
            if self.yield_intermediate:
                out.append(new)
            if self.stack:
                current = new
        if not self.yield_intermediate:
            return [current]
        return out
