"""Hyperparameter search: the TPE sampler of ``+search``.

Counterpart of ``w2v2_speaker_tpu/runtime/sweeper.py`` (a from-scratch
Tree-structured Parzen Estimator with optuna's ask/tell surface): the
same search-space grammar of ``config/search/*.yaml``,

    search_space:
      optim.algo.lr:        {type: float, low: 1e-8, high: 1, log: true}
      optim.loss.scale:     {type: int, low: 1, high: 50}
      network.stat_pooling_type: {type: categorical, choices: [mean, max]}
      optim/schedule:       {type: categorical, choices: [tri_stage, one_cycle]}

whose keys are command-line override keys (dots for values, slashes for
config-group swaps), so a trial is a list of ``key=value`` overrides
(``format_override``). The first ``n_startup_trials`` trials draw from
the prior (uniform, log-uniform or categorical); after that, the told
trials are split at the ``gamma`` quantile of the objective into good and
bad, each dimension gets a Parzen estimator of each (Scott's-rule
bandwidth, floored at 1/50 of the range; Laplace-smoothed frequencies for
a categorical), and the candidate with the largest l(x) / g(x) is asked.
Every draw comes from one ``numpy.random.default_rng(seed)`` in the same
order as the JAX package's, so at one seed and the same told objectives
both ask the same trials.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["TPESampler", "format_override"]


def format_override(key: str, value: Any) -> str:
    """Render a sampled value as a CLI override token."""
    if isinstance(value, float):
        return f"{key}={value:.10g}"
    return f"{key}={value}"


class _FloatDim:
    def __init__(self, low, high, log=False, integer=False):
        # YAML 1.1 leaves dot-less scientific notation ('1e-8') as strings
        low, high = float(low), float(high)
        if log and low <= 0:
            raise ValueError("log-scale dimension needs low > 0")
        self.low, self.high = low, high
        self.log = bool(log)
        self.integer = integer

    def _warp(self, x):
        return math.log(x) if self.log else float(x)

    def _unwarp(self, z):
        x = math.exp(z) if self.log else z
        x = min(max(x, self.low), self.high)
        return int(round(x)) if self.integer else float(x)

    def sample_prior(self, rng: np.random.Generator):
        z = rng.uniform(self._warp(self.low), self._warp(self.high))
        return self._unwarp(z)

    def _kde(self, zs: np.ndarray):
        """(centers, bandwidth) Parzen estimator with a Scott's-rule
        bandwidth, floored so a handful of clustered points can't collapse
        the search."""
        lo, hi = self._warp(self.low), self._warp(self.high)
        span = hi - lo
        if len(zs) > 1:
            bw = max(np.std(zs) * len(zs) ** -0.2, span / 50)
        else:
            bw = span / 6
        return zs, bw

    @staticmethod
    def _logpdf(z, centers, bw):
        d = (z - centers[:, None]) / bw
        # mean over mixture components, log for ratio stability
        comp = -0.5 * d * d - math.log(bw) - 0.5 * math.log(2 * math.pi)
        m = comp.max(axis=0)
        return m + np.log(np.exp(comp - m).mean(axis=0) + 1e-300)

    def sample_tpe(self, rng, good: Sequence, bad: Sequence, n_candidates):
        zg = np.asarray([self._warp(v) for v in good])
        zb = np.asarray([self._warp(v) for v in bad])
        centers, bw = self._kde(zg)
        lo, hi = self._warp(self.low), self._warp(self.high)
        # candidates from l(x): pick a good point, jitter by the bandwidth;
        # mix in a few prior draws so the estimator can escape local modes
        picks = centers[rng.integers(0, len(centers), n_candidates)]
        cand = picks + rng.normal(0, bw, n_candidates)
        cand = np.clip(cand, lo, hi)
        cand[: max(1, n_candidates // 4)] = rng.uniform(
            lo, hi, max(1, n_candidates // 4)
        )
        score = self._logpdf(cand, centers, bw)
        if len(zb):
            cb, bwb = self._kde(zb)
            score = score - self._logpdf(cand, cb, bwb)
        return self._unwarp(float(cand[int(np.argmax(score))]))


class _CategoricalDim:
    def __init__(self, choices: Sequence):
        if not choices:
            raise ValueError("categorical dimension needs choices")
        self.choices = list(choices)

    def sample_prior(self, rng):
        return self.choices[int(rng.integers(0, len(self.choices)))]

    def _probs(self, observed: Sequence):
        # Laplace-smoothed category frequencies
        counts = np.array(
            [1.0 + sum(1 for v in observed if v == c) for c in self.choices]
        )
        return counts / counts.sum()

    def sample_tpe(self, rng, good, bad, n_candidates):
        pg = self._probs(good)
        pb = self._probs(bad) if bad else np.full(len(self.choices), 1.0)
        ratio = pg / pb
        # sample from l, keep the best l/g among the sampled candidates
        idx = rng.choice(len(self.choices), size=n_candidates, p=pg)
        best = idx[int(np.argmax(ratio[idx]))]
        return self.choices[int(best)]


def _make_dim(spec: Dict):
    kind = spec.get("type")
    if kind == "float":
        return _FloatDim(spec["low"], spec["high"], spec.get("log", False))
    if kind == "int":
        return _FloatDim(
            spec["low"], spec["high"], spec.get("log", False), integer=True
        )
    if kind == "categorical":
        return _CategoricalDim(spec["choices"])
    raise ValueError(f"unknown search dimension type: {kind!r}")


class TPESampler:
    """ask/tell optimizer over a reference-grammar search space."""

    def __init__(
        self,
        search_space: Dict[str, Dict],
        seed: int = 123,
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        direction: str = "minimize",
    ):
        if direction not in ("minimize", "maximize"):
            raise ValueError(f"unknown direction {direction!r}")
        self.dims = {k: _make_dim(v) for k, v in search_space.items()}
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.sign = 1.0 if direction == "minimize" else -1.0
        self.trials: List[Tuple[Dict[str, Any], float]] = []

    def ask(self) -> Dict[str, Any]:
        if len(self.trials) < self.n_startup_trials:
            return {
                k: d.sample_prior(self.rng) for k, d in self.dims.items()
            }
        ordered = sorted(self.trials, key=lambda t: self.sign * t[1])
        n_good = max(1, math.ceil(self.gamma * len(ordered)))
        good, bad = ordered[:n_good], ordered[n_good:]
        params = {}
        for k, d in self.dims.items():
            gv = [t[0][k] for t in good]
            bv = [t[0][k] for t in bad]
            params[k] = d.sample_tpe(self.rng, gv, bv, self.n_candidates)
        return params

    def tell(self, params: Dict[str, Any], objective: float) -> None:
        if math.isfinite(objective):
            self.trials.append((dict(params), float(objective)))

    @property
    def best(self) -> Tuple[Dict[str, Any], float]:
        if not self.trials:
            raise ValueError("no completed trials")
        return min(self.trials, key=lambda t: self.sign * t[1])
