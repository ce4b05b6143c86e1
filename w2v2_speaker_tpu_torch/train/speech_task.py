"""Speech-recognition (CTC) task: loss, greedy decoding and WER.

Counterpart of ``w2v2_speaker_tpu/train/speech_task.py``: ``SpeechTask``
(:71) with ``loss_fn`` (CTC over the frame logits, blank 0, the lengths
from the model's ``frame_mask``, :95-137), ``logits_fn`` (:141),
``transcribe`` (:159) and ``evaluate_wer`` (:170), and
``evaluate_wer_over_batches`` (:29): corpus WER over batches that carry
``transcriptions``, greedy argmax decoding on the host. There is no mesh,
so nothing pads an eval batch's rows (the JAX function's
``pad_rows_to``).

The model contract: ``model(features, mask, train=..., generator=...)``
returns a dict with float32 ``logits`` [B, T, V] and ``frame_mask``
[B, T] (or None).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.tokenizer import CharTokenizer
from ..eval.metrics import calculate_wer
from ..objectives import losses

__all__ = ["SpeechTask", "evaluate_wer_over_batches"]

LogitsFn = Callable[[Any, Any], Tuple[Any, Any]]


def evaluate_wer_over_batches(tokenizer: CharTokenizer, batches: Iterable[Dict],
                              logits_fn: LogitsFn) -> Dict[str, float]:
    """``{"wer"}`` over ``batches`` (``features``, optional ``mask``,
    ``transcriptions``) through ``logits_fn(features, mask) -> (logits
    [B, T, V], lengths [B])``, decoded greedily on the host."""
    hyps: List[str] = []
    refs: List[str] = []
    for batch in batches:
        logits, lengths = logits_fn(batch["features"], batch.get("mask"))
        hyps.extend(tokenizer.decode_batch(_numpy(logits), _numpy(lengths)))
        refs.extend(batch["transcriptions"])
    return {"wer": calculate_wer(hyps, refs)}


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class SpeechTask:
    model: nn.Module
    tokenizer: CharTokenizer

    def loss_fn(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(CTC loss, aux) with aux = {"metrics", "out"}; ``batch`` holds
        ``features``, ``mask``, ``labels`` and ``label_lengths``. In
        training the metrics also carry ``layers_run``."""
        out = self.model(batch["features"], batch.get("mask"), train=train, generator=generator)
        logits = out["logits"]
        lengths = losses.frame_lengths(logits, out["frame_mask"])
        loss = losses.ctc_loss(logits, lengths, batch["labels"], batch["label_lengths"],
                               blank_id=self.tokenizer.blank_id)
        metrics: Dict[str, Any] = {"loss": loss.detach()}
        if train:
            metrics["layers_run"] = self.model.wav2vec2.encoder.layers_run
        return loss, {"metrics": metrics, "out": {"logits": logits, "logit_lengths": lengths}}

    @torch.inference_mode()
    def logits_fn(self, features: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """Eval forward: (logits [B, T, V], lengths [B])."""
        out = self.model(features, mask, train=False)
        return out["logits"], losses.frame_lengths(out["logits"], out["frame_mask"])

    def host_logits_fn(self, features, mask=None):
        """``logits_fn`` of numpy (or tensor) inputs, moved to the model's
        device first."""
        dev = next(self.model.parameters()).device
        return self.logits_fn(torch.as_tensor(features, device=dev),
                              None if mask is None else torch.as_tensor(mask, device=dev))

    def transcribe(self, batch: Dict) -> List[str]:
        """Greedy CTC transcriptions of a batch (numpy or tensors)."""
        logits, lengths = self.host_logits_fn(batch["features"], batch.get("mask"))
        return self.tokenizer.decode_batch(_numpy(logits), _numpy(lengths))

    def evaluate_wer(self, batches: Iterable[Dict], logits_fn: Optional[LogitsFn] = None) -> Dict[str, float]:
        """Corpus WER over ``batches`` through ``logits_fn``, by default
        ``host_logits_fn``."""
        return evaluate_wer_over_batches(self.tokenizer, batches, logits_fn or self.host_logits_fn)
