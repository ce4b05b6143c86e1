"""Speaker-recognition task: the losses of the ``ce``, ``aam``,
``ce_no_pool``, ``triplet``, ``triplet_ce`` and ``speaker_ctc`` training
modes.

Counterpart of ``w2v2_speaker_tpu/train/speaker_task.py::SpeakerTask``
(:43): ``ce`` takes the model's logits against the speaker labels with
``cross_entropy``; ``aam`` hands the labels to the model, whose AAM head
returns the loss and predictions (:91-92, :131-132); ``ce_no_pool``
(:135-156) takes every frame's logits against its utterance's label, the
mean over the valid frames of the model's ``frame_mask``; ``speaker_ctc``
(:173-189) runs CTC over the frame logits (class 0 the blank) against a
one-token target, the label + 1; ``triplet`` (:156-163) takes the triplet
margin loss over the embeddings with triplets mined in the batch from the
step's generator, and ``triplet_ce`` (:164-172) adds it, weighted by
``c_triplet``, to ``c_ce`` x the CE of the logits. The loss and accuracy
metrics as :114-126.

The model contract: ``model(features, mask, train=..., generator=...)``
(and ``labels=`` under ``aam``) returns a dict with ``embedding`` [B, D],
``logits`` [B, C] (None under ``aam``), and under ``aam`` ``loss`` and
``preds``; in the frame-level modes ``[B, T, ...]`` embeddings and logits
and ``frame_mask`` [B, T] (or None).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..objectives import losses
from ..parallel.mesh import global_mean

__all__ = ["SpeakerTask", "TRAINING_MODES"]

TRAINING_MODES = ("ce", "ce_no_pool", "aam", "triplet", "triplet_ce", "speaker_ctc")


@dataclass
class SpeakerTask:
    model: nn.Module
    mode: str = "ce"
    triplet_margin: float = 1.0
    c_ce: float = 1.0
    c_triplet: float = 1.0

    def __post_init__(self):
        if self.mode not in TRAINING_MODES:
            raise ValueError(f"unknown training mode {self.mode}; one of {TRAINING_MODES}")

    def loss_fn(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(loss, aux) with aux = {"metrics", "out"}. In training the
        metrics also carry ``layers_run``, the encoder layers this forward
        ran (the rest were dropped by layerdrop)."""
        labels = batch.get("labels")
        kwargs = {"labels": labels} if self.mode == "aam" else {}
        out = self.model(batch["features"], batch.get("mask"), train=train, generator=generator,
                         **kwargs)
        loss, preds = self._compute_loss(out, batch, generator)
        metrics: Dict[str, Any] = {"loss": loss.detach()}
        if labels is not None and preds is not None and preds.ndim == 2 and preds.shape[0] == labels.shape[0]:
            metrics["accuracy"] = global_mean((preds.argmax(-1) == labels).float())
        encoder = getattr(getattr(self.model, "wav2vec2", None), "encoder", None)
        if train and encoder is not None:
            metrics["layers_run"] = encoder.layers_run
        return loss, {"metrics": metrics, "out": out}

    def _compute_loss(self, out, batch, generator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        labels = batch.get("labels")
        if self.mode == "aam":
            return out["loss"], out["preds"]
        if self.mode == "ce":
            return losses.cross_entropy(out["logits"], labels)
        if self.mode == "triplet":
            return losses.triplet_loss(out["embedding"], labels, generator, self.triplet_margin), None
        if self.mode == "triplet_ce":
            return losses.triplet_cross_entropy(out["embedding"], out["logits"], labels, generator, self.c_ce,
                                                self.c_triplet, self.triplet_margin)
        logits = out["logits"]  # [B, T, C]
        mask = out["frame_mask"]
        if self.mode == "ce_no_pool":
            b, t, c = logits.shape
            weights = None if mask is None else mask.reshape(b * t)
            return losses.cross_entropy(logits.reshape(b * t, c), labels.repeat_interleave(t), weights)
        # speaker_ctc
        lengths = losses.frame_lengths(logits, mask)
        target = (labels + 1)[:, None]
        return losses.ctc_loss(logits, lengths, target, torch.ones_like(labels)), None

    @torch.no_grad()
    def embed_fn(self, features: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Deterministic speaker-embedding extraction (eval path)."""
        return self.model(features, mask, train=False)["embedding"]
