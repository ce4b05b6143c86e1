"""The port's main-path program, counterpart of ``__graft_entry__.entry()``
(``__graft_entry__.py:15-77``).

wav2vec2-BASE -> masked mean pooling -> FC head over 5994 speakers
(VoxCeleb2 dev), speaker-embedding extraction on B=48 x 48 000-sample
(3 s) clips. Random weights from a seeded ``torch.Generator``: bfloat16
backbone weights and compute on the card, float32 on the CPU. Every
attention call on the card launches the hand-written flash-attention
kernel (12 launches per forward).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .device import DeviceLike, resolve_device, set_float32_precision
from .models.wav2vec2 import Wav2Vec2Config, init_parameters
from .models.wav2vec2_speaker import Wav2Vec2SpeakerConfig, Wav2Vec2SpeakerModel

__all__ = ["entry", "build_model", "NUM_SPEAKERS", "BATCH", "SAMPLES"]

NUM_SPEAKERS = 5994
BATCH, SAMPLES = 48, 48000


def build_model(
    device: torch.device, dtype: torch.dtype, seed: int = 0
) -> Wav2Vec2SpeakerModel:
    """BASE + mean pooling + FC head, eval mode, weights drawn on ``device``
    from ``torch.Generator(device).manual_seed(seed)``. On the card it sets
    full float32 for f32 matmuls and convolutions (``set_float32_precision``)."""
    if device.type == "cuda":
        set_float32_precision()
    cfg = Wav2Vec2SpeakerConfig(
        w2v2=Wav2Vec2Config(dtype=str(dtype).removeprefix("torch."), layerdrop=0.0),
        stat_pooling_type="mean",
    )
    with torch.device("meta"):
        model = Wav2Vec2SpeakerModel(cfg, num_speakers=NUM_SPEAKERS)
    model.to_empty(device=device)
    init_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def entry(
    device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> Tuple[Callable, tuple]:
    """``(forward, (model, example_wav))``; ``forward(model, wav)`` returns
    the ``[B, 768]`` float32 embeddings. Runs on the card unless
    ``device="cpu"``; raises without a card."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = build_model(dev, dtype)
    example_wav = torch.zeros((BATCH, SAMPLES), dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def forward(model: Wav2Vec2SpeakerModel, wav: torch.Tensor) -> torch.Tensor:
        return model.compute_embedding(wav)

    return forward, (model, example_wav)
