"""Joint speaker and speech recognition task: one backbone forward a step
feeds CTC and the speaker CE or AAM.

Counterpart of ``w2v2_speaker_tpu/train/multitask_task.py::MultitaskTask``
(:38):

    loss = speech_weight * CTC(ctc_logits, tokens)
         + speaker_weight * (CE | AAM)(speaker logits | embedding, speaker)

with ``loss_speech``, ``loss_speaker`` and the speaker ``accuracy`` in the
metrics (:93-158). Rows whose ``label_lengths`` is 0 are padding (the train
loop pads a token-budget batch's rows to a multiple of the accumulation
count with empty labels): they leave the CTC mean (``ctc_loss``) and, as
``row_valid`` weights, the CE or AAM mean and the accuracy. Batches need
``speaker_labels`` (``data.module.with_speaker_labels``, which the run
forces for this network). It is a ``SpeechTask`` whose ``logits_fn``
reads the CTC head: the WER validation and the tracked transcription run
as the speech task's do; ``embed_fn`` serves the speaker EER.

The model contract: ``Wav2Vec2MultitaskModel`` (``ctc_logits``,
``frame_mask``, ``embedding``, ``logits``, and under AAM with labels
``loss`` and ``preds``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..objectives import losses
from ..parallel.mesh import global_mean
from .speech_task import SpeechTask

__all__ = ["MultitaskTask"]


@dataclass
class MultitaskTask(SpeechTask):
    mode: str = "ce"  # the speaker objective: "ce" | "aam"
    speech_weight: float = 1.0
    speaker_weight: float = 1.0

    def __post_init__(self):
        if self.mode not in ("ce", "aam"):
            raise ValueError(f"unknown speaker mode {self.mode}")

    def loss_fn(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(loss, aux) with aux = {"metrics", "out"}; ``batch`` holds
        ``features``, ``mask``, ``labels`` [B, S], ``label_lengths`` and
        ``speaker_labels``. In training the metrics also carry
        ``layers_run``."""
        speaker_labels = batch.get("speaker_labels")
        if speaker_labels is None:
            raise ValueError(
                "multitask batches need 'speaker_labels' — set data.module.with_speaker_labels=true")
        row_valid = (batch["label_lengths"] > 0).float()
        kwargs = {"labels": speaker_labels, "label_weights": row_valid} if self.mode == "aam" else {}
        out = self.model(batch["features"], batch.get("mask"), train=train, generator=generator, **kwargs)
        ctc_logits = out["ctc_logits"]
        lengths = losses.frame_lengths(ctc_logits, out["frame_mask"])
        loss_speech = losses.ctc_loss(ctc_logits, lengths, batch["labels"], batch["label_lengths"],
                                      blank_id=self.tokenizer.blank_id)
        if self.mode == "aam":
            loss_speaker, preds = out["loss"], out["preds"]
        else:
            loss_speaker, preds = losses.cross_entropy(out["logits"], speaker_labels, weights=row_valid)
        loss = self.speech_weight * loss_speech + self.speaker_weight * loss_speaker
        correct = (preds.argmax(-1) == speaker_labels).float()
        metrics: Dict[str, Any] = {
            "loss": loss.detach(), "loss_speech": loss_speech.detach(), "loss_speaker": loss_speaker.detach(),
            "accuracy": global_mean(correct, row_valid),
        }
        if train:
            metrics["layers_run"] = self.model.wav2vec2.encoder.layers_run
        return loss, {"metrics": metrics,
                      "out": {"embedding": out["embedding"], "logits": ctc_logits, "logit_lengths": lengths}}

    @torch.inference_mode()
    def logits_fn(self, features: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Eval forward: (CTC logits [B, T, V], lengths [B])."""
        out = self.model(features, mask, train=False)
        return out["ctc_logits"], losses.frame_lengths(out["ctc_logits"], out["frame_mask"])

    @torch.inference_mode()
    def embed_fn(self, features: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic speaker-embedding extraction (eval path)."""
        return self.model.compute_embedding(features, mask)
