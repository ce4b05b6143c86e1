"""Paired speaker-verification task: BCE on the equality logit.

Counterpart of ``w2v2_speaker_tpu/train/paired_task.py``:
``PairedSpeakerTask`` (:28) with ``loss_fn`` (BCE-with-logits and the
``accuracy`` metric, :49-88) and ``score_fn`` (sigmoid scores, :90-101),
and ``paired_scores_to_metrics`` (:104): EER and minDCF straight from the
scores of a trial list, with the reference's sentinel fallbacks (1 and
threshold 1337) where a metric cannot be computed.

The model contract: ``model(features_a, features_b, mask_a, mask_b,
train=..., generator=...)`` returns a dict with ``logit`` [B, 1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..eval.metrics import calculate_eer, calculate_mdc
from ..objectives import losses
from ..parallel.mesh import global_mean

__all__ = ["PairedSpeakerTask", "paired_scores_to_metrics"]


@dataclass
class PairedSpeakerTask:
    model: nn.Module

    def _forward(self, batch: Dict[str, torch.Tensor], generator, train: bool) -> Dict[str, torch.Tensor]:
        return self.model(batch["features_a"], batch["features_b"], batch.get("mask_a"), batch.get("mask_b"),
                          train=train, generator=generator)

    def loss_fn(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(loss, aux) with aux = {"metrics", "out"}, as
        ``SpeakerTask.loss_fn``; in training the metrics also carry
        ``layers_run``."""
        out = self._forward(batch, generator, train)
        labels = batch["labels"]
        loss, preds = losses.binary_cross_entropy(out["logit"], labels)
        metrics: Dict[str, Any] = {
            "loss": loss.detach(),
            "accuracy": global_mean(((preds > 0.5) == (labels.reshape(-1) > 0.5)).float()),
        }
        if train:
            metrics["layers_run"] = self.model.encoder.layers_run
        return loss, {"metrics": metrics, "out": out}

    @torch.no_grad()
    def score_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B] float32 sigmoid equality scores of a batch of trial pairs."""
        return torch.sigmoid(self._forward(batch, None, False)["logit"].reshape(-1))


def paired_scores_to_metrics(ground_truth, scores) -> Dict[str, float]:
    """EER / minDCF and their thresholds from sigmoid scores; a metric that
    raises ``ValueError`` or ``ZeroDivisionError`` reads 1 at threshold
    1337."""
    gt = list(np.asarray(ground_truth).astype(int))
    sc = list(np.asarray(scores).astype(float))
    try:
        eer, eer_threshold = calculate_eer(gt, sc)
    except (ValueError, ZeroDivisionError):
        eer, eer_threshold = 1, 1337
    try:
        mdc, mdc_threshold = calculate_mdc(gt, sc)
    except (ValueError, ZeroDivisionError):
        mdc, mdc_threshold = 1, 1337
    return {
        "eer": float(eer),
        "eer_threshold": float(eer_threshold),
        "mdc": float(mdc),
        "mdc_threshold": float(mdc_threshold),
    }
