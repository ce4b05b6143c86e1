"""Subspace scoring backends (copy of ``w2v2_speaker_tpu/eval/backends.py``):
whitened ``PCA`` (:36), two-covariance ``TwoCovPLDA`` trained by EM (:66),
``LDAEvaluator`` (:141; PCA, then centering and length-norm in the latent
space, then cosine) and ``PLDAEvaluator`` (:182; PCA, centering,
length-norm, then the PLDA log-likelihood ratio, scored as 10 ** llr with
the exponent clamped to [-30, 30]).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .evaluator import (
    SpeakerRecognitionEvaluator,
    center,
    compute_mean_std,
    length_norm,
)

__all__ = ["PCA", "TwoCovPLDA", "LDAEvaluator", "PLDAEvaluator"]


class PCA:
    """Whitened PCA via SVD (sklearn PCA(whiten=True) semantics)."""

    def __init__(self, num_components: int, whiten: bool = True):
        self.num_components = num_components
        self.whiten = whiten
        self.mean: Optional[np.ndarray] = None
        self.components: Optional[np.ndarray] = None  # [k, D]
        self.scale: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "PCA":
        n, d = x.shape
        k = min(self.num_components, n, d)
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        u, s, vt = np.linalg.svd(xc, full_matrices=False)
        self.components = vt[:k]
        # whitening scale: singular values -> unit variance components
        self.scale = s[:k] / np.sqrt(max(n - 1, 1))
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        if self.components is None:
            raise ValueError("PCA not fitted")
        z = (x - self.mean) @ self.components.T
        if self.whiten:
            z = z / np.maximum(self.scale, 1e-12)
        return z


class TwoCovPLDA:
    """Two-covariance PLDA: x = mu + y + e, y ~ N(0, B), e ~ N(0, W).

    Trained with EM over speaker-labeled embeddings; scores pairs with the
    same/different log-likelihood ratio.
    """

    def __init__(self, num_iterations: int = 10):
        self.num_iterations = num_iterations
        self.mu: Optional[np.ndarray] = None
        self.B: Optional[np.ndarray] = None
        self.W: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, labels: np.ndarray) -> "TwoCovPLDA":
        d = x.shape[1]
        self.mu = x.mean(axis=0)
        xc = x - self.mu

        speakers = np.unique(labels)
        groups = [xc[labels == s] for s in speakers]

        # moment initialization: between/within scatter
        means = np.stack([g.mean(axis=0) for g in groups])
        self.B = np.cov(means.T) + 1e-4 * np.eye(d)
        within = np.concatenate([g - g.mean(axis=0) for g in groups])
        self.W = np.cov(within.T) + 1e-4 * np.eye(d)

        for _ in range(self.num_iterations):
            b_inv = np.linalg.inv(self.B)
            w_inv = np.linalg.inv(self.W)
            new_b = np.zeros_like(self.B)
            new_w = np.zeros_like(self.W)
            n_total = 0
            for g in groups:
                n = g.shape[0]
                l_cov = np.linalg.inv(b_inv + n * w_inv)
                post_mean = l_cov @ (w_inv @ (n * g.mean(axis=0)))
                new_b += np.outer(post_mean, post_mean) + l_cov
                resid = g - post_mean
                new_w += resid.T @ resid + n * l_cov
                n_total += n
            self.B = new_b / len(groups) + 1e-6 * np.eye(d)
            self.W = new_w / n_total + 1e-6 * np.eye(d)
        return self

    def llr(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        """Pairwise (row-wise) same/different-speaker LLR for [N, D] pairs."""
        if self.mu is None:
            raise ValueError("PLDA not fitted")
        x1 = x1 - self.mu
        x2 = x2 - self.mu
        sigma = self.B + self.W  # total covariance
        sigma_inv = np.linalg.inv(sigma)
        # same-speaker joint covariance [[S, B], [B, S]] inverse blocks
        schur = sigma - self.B @ sigma_inv @ self.B
        e_blk = np.linalg.inv(schur)
        f_blk = -sigma_inv @ self.B @ e_blk

        def quad(a, m, b):
            return np.einsum("nd,de,ne->n", a, m, b)

        ll_same = -0.5 * (
            quad(x1, e_blk, x1) + 2 * quad(x1, f_blk, x2) + quad(x2, e_blk, x2)
        )
        ll_diff = -0.5 * (
            quad(x1, sigma_inv, x1) + quad(x2, sigma_inv, x2)
        )
        sign_s, logdet_s = np.linalg.slogdet(
            np.block([[sigma, self.B], [self.B, sigma]])
        )
        sign_d, logdet_d = np.linalg.slogdet(sigma)
        const = -0.5 * (logdet_s - 2 * logdet_d)
        return ll_same - ll_diff + const


class LDAEvaluator(SpeakerRecognitionEvaluator):
    """PCA(whiten) -> center + length-norm in latent space -> cosine."""

    def __init__(
        self,
        num_pca_components: int = 200,
        max_num_training_samples: int = 0,
    ):
        super().__init__(max_num_training_samples)
        self.num_pca_components = num_pca_components
        self.pca: Optional[PCA] = None
        self.mean = None
        self.std = None

    def fit_parameters(self, embedding_tensors, label_tensors=None):
        x = np.stack(list(embedding_tensors))
        self.pca = PCA(self.num_pca_components, whiten=True).fit(x)
        z = self.pca.transform(x)
        self.mean, self.std = compute_mean_std(z)

    def reset_parameters(self):
        self.pca = None
        self.mean = None
        self.std = None

    def _project(self, emb: np.ndarray) -> np.ndarray:
        z = self.pca.transform(emb)
        z = center(z, self.mean, self.std)
        return length_norm(z)

    def _compute_prediction_scores(self, pairs):
        if self.pca is None:
            raise ValueError("evaluator not fitted; call fit_parameters")
        left = self._project(np.stack([np.asarray(a.embedding) for a, _ in pairs]))
        right = self._project(np.stack([np.asarray(b.embedding) for _, b in pairs]))
        denom = np.maximum(
            np.linalg.norm(left, axis=1) * np.linalg.norm(right, axis=1), 1e-8
        )
        return ((left * right).sum(axis=1) / denom).tolist()


class PLDAEvaluator(SpeakerRecognitionEvaluator):
    """PCA -> center + length-norm -> two-covariance PLDA LLR scoring."""

    def __init__(
        self,
        num_pca_components: int = 100,
        num_em_iterations: int = 10,
        max_num_training_samples: int = 0,
    ):
        super().__init__(max_num_training_samples)
        self.num_pca_components = num_pca_components
        self.num_em_iterations = num_em_iterations
        self.pca: Optional[PCA] = None
        self.plda: Optional[TwoCovPLDA] = None
        self.mean = None
        self.std = None

    def fit_parameters(self, embedding_tensors, label_tensors=None):
        if label_tensors is None:
            raise ValueError("PLDA training requires speaker labels")
        x = np.stack(list(embedding_tensors))
        labels = np.asarray(list(label_tensors))
        self.pca = PCA(self.num_pca_components, whiten=True).fit(x)
        z = self._project_pre_plda(x, fit=True)
        self.plda = TwoCovPLDA(self.num_em_iterations).fit(z, labels)

    def _project_pre_plda(self, x: np.ndarray, fit: bool = False):
        z = self.pca.transform(x)
        if fit:
            self.mean, self.std = compute_mean_std(z)
        z = center(z, self.mean, self.std)
        return length_norm(z)

    def reset_parameters(self):
        self.pca = None
        self.plda = None
        self.mean = None
        self.std = None

    def _compute_prediction_scores(self, pairs):
        if self.plda is None:
            raise ValueError("evaluator not fitted; call fit_parameters")
        left = self._project_pre_plda(
            np.stack([np.asarray(a.embedding) for a, _ in pairs])
        )
        right = self._project_pre_plda(
            np.stack([np.asarray(b.embedding) for _, b in pairs])
        )
        llr = self.plda.llr(left, right)
        # reference quirk: scores are 10**llr before the evaluator's
        # (s+1)/2 clip; clamp the exponent so the monotone map can't overflow
        return np.power(10.0, np.clip(llr, -30.0, 30.0)).tolist()
