"""The port's main-path programs.

- ``entry()``, counterpart of ``__graft_entry__.entry()``
  (``__graft_entry__.py:15-77``): wav2vec2-BASE -> masked mean pooling -> FC
  head over 5994 speakers (VoxCeleb2 dev), speaker-embedding extraction on
  B=48 x 48 000-sample (3 s) clips. bfloat16 backbone weights and compute on
  the card, float32 on the CPU. Every attention call on the card launches
  the hand-written flash-attention forward (12 launches per forward).
- ``train_entry()``, counterpart of one dispatch of the
  ``speaker_wav2vec2_ce`` recipe's training loop (``run.py``): the same
  model with the recipe's regularisation (dropout 0.1 at the feature
  projection, hidden and attention sites, layerdrop 0.05, SpecAugment time
  masks), CE loss, Adam under the one-cycle schedule, float32 parameters
  with bfloat16 autocast on the card (float32 on the CPU), four steps per
  dispatch on stacked B=66 x 48 000-sample batches. On the card each kept
  layer launches the forward, dq and dk/dv kernels once per step.
- ``large_train_entry()``, one dispatch of the ``speaker_wav2vec2_large_aam``
  recipe: wav2vec2-LARGE (24 x 1024, 16 heads, pre-norm, conv bias and a
  LayerNorm after every conv), the AAM-softmax head (margin 0.2, scale 30),
  Adam lr 5e-5 under one-cycle, four steps of B=48 x 48 000 samples, with
  ``network.conv_impl=fused_pallas`` by default: on the card each forward
  launches the fused conv kernel for conv layers 1-6 and each kept layer
  the three attention kernels. ``build_model(..., size="large",
  conv_impl="fused_pallas", use_aam=True)`` is its serving model.

Random weights come from a seeded ``torch.Generator``, synthetic batches
and labels from numpy's seeded generator.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device, set_float32_precision
from .models.wav2vec2 import BASE_CONFIG, LARGE_CONFIG, Wav2Vec2Config, init_parameters
from .models.wav2vec2_speaker import Wav2Vec2SpeakerConfig, Wav2Vec2SpeakerModel
from .runtime.experiment import build_optimizer, load_recipe, speaker_model_config
from .train.speaker_task import SpeakerTask
from .train.state import TrainState
from .train.steps import make_train_step

__all__ = [
    "entry", "train_entry", "large_train_entry", "build_model", "build_train_state",
    "synthetic_batch", "NUM_SPEAKERS", "BATCH", "SAMPLES",
]

NUM_SPEAKERS = 5994
BATCH, SAMPLES = 48, 48000


def _random_model(cfg: Wav2Vec2SpeakerConfig, device: torch.device, seed: int):
    """The model with float32 parameters drawn on ``device`` from
    ``torch.Generator(device).manual_seed(seed)``; on the card it sets full
    float32 for f32 matmuls and convolutions (``set_float32_precision``)."""
    if device.type == "cuda":
        set_float32_precision()
    with torch.device("meta"):
        model = Wav2Vec2SpeakerModel(cfg, num_speakers=NUM_SPEAKERS)
    model.to_empty(device=device)
    init_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model


def build_model(
    device: torch.device, dtype: torch.dtype, seed: int = 0, size: str = "base",
    conv_impl: str = "xla", use_aam: bool = False,
) -> Wav2Vec2SpeakerModel:
    """wav2vec2 ``size`` ("base" or "large") + mean pooling + FC head (or,
    with ``use_aam``, the AAM head) for serving, eval mode: the backbone's
    weights cast to ``dtype`` (as the JAX entry casts its variables)."""
    base = {"base": BASE_CONFIG, "large": LARGE_CONFIG}[size]
    cfg = Wav2Vec2SpeakerConfig(
        w2v2=Wav2Vec2Config(**{**base.__dict__, "dtype": str(dtype).removeprefix("torch."),
                               "layerdrop": 0.0, "conv_impl": conv_impl}),
        stat_pooling_type="mean",
        use_aam=use_aam,
    )
    model = _random_model(cfg, device, seed)
    model.wav2vec2.to(dtype)
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


def build_train_state(
    device: torch.device,
    precision: str,
    cfg: Optional[Dict] = None,
    seed: int = 0,
    num_layers: Optional[int] = None,
) -> Tuple[TrainState, SpeakerTask]:
    """(state, task) of the recipe ``cfg`` (default: ``speaker_wav2vec2_ce``
    from ``config/``) on ``device`` at ``precision`` ("bf16" or "f32"):
    random float32 weights from ``seed``, the step generator seeded with
    ``seed`` too. ``num_layers`` cuts the depth (the widths stay)."""
    if cfg is None:
        cfg = load_recipe("speaker_wav2vec2_ce")
    model_cfg, mode = speaker_model_config(
        {**cfg, "trainer": {**cfg["trainer"], "precision": precision}})
    if num_layers is not None:
        w2v2 = Wav2Vec2Config(**{**model_cfg.w2v2.__dict__, "num_layers": num_layers})
        model_cfg = Wav2Vec2SpeakerConfig(**{**model_cfg.__dict__, "w2v2": w2v2})
    model = _random_model(model_cfg, device, seed)
    return TrainState.create(model, build_optimizer(cfg), seed=seed), SpeakerTask(model, mode)


def synthetic_batch(
    batch: int, samples: int, device: torch.device, seed: int = 0, steps: int = 1
) -> Dict[str, torch.Tensor]:
    """``steps`` stacked batches of unpadded random clips (``features``,
    all-valid ``mask``) with random labels over the 5994 speakers, each
    entry ``[steps, batch, ...]``."""
    rng = np.random.default_rng(seed)
    return {
        "features": torch.from_numpy(
            rng.normal(0, 0.1, (steps, batch, samples)).astype(np.float32)).to(device),
        "mask": torch.ones((steps, batch, samples), dtype=torch.bool, device=device),
        "labels": torch.from_numpy(rng.integers(0, NUM_SPEAKERS, (steps, batch))).to(device),
    }


def _recipe_entry(cfg: Dict, device: DeviceLike, batch: int, samples: int):
    dev = resolve_device(device)
    precision = cfg["trainer"]["precision"] if dev.type == "cuda" else "f32"
    state, task = build_train_state(dev, precision, cfg)
    k = cfg["trainer"]["steps_per_dispatch"]
    step = make_train_step(
        task, accumulate_steps=cfg["trainer"]["accumulate_grad_batches"], steps_per_dispatch=k
    )
    return step, (state, synthetic_batch(batch, samples, dev, steps=k))


def train_entry(
    device: DeviceLike = None, batch: int = 66, samples: int = SAMPLES
) -> Tuple[Callable, tuple]:
    """``(step, (state, example_batch))`` of the ``speaker_wav2vec2_ce``
    recipe: ``step(state, example_batch)`` runs one dispatch of four
    training steps and returns ``(state, metrics)`` with ``[4]``-stacked
    ``loss``, ``accuracy`` and ``layers_run``. Precision is the recipe's
    bf16 on the card, f32 on the CPU. Runs on the card unless
    ``device="cpu"``; raises without a card."""
    return _recipe_entry(load_recipe("speaker_wav2vec2_ce"), device, batch, samples)


def large_train_entry(
    device: DeviceLike = None, batch: int = 48, samples: int = SAMPLES,
    conv_impl: str = "fused_pallas",
) -> Tuple[Callable, tuple]:
    """``train_entry`` for the ``speaker_wav2vec2_large_aam`` recipe with
    ``network.conv_impl=conv_impl``: wav2vec2-LARGE, the AAM head, four
    steps per dispatch of B=``batch`` clips; the metrics as
    ``train_entry``'s, ``accuracy`` from the AAM head's predictions."""
    cfg = load_recipe("speaker_wav2vec2_large_aam", [f"network.conv_impl={conv_impl}"])
    return _recipe_entry(cfg, device, batch, samples)
