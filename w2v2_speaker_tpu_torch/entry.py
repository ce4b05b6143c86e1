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
- ``dryrun_multichip(n)``, counterpart of ``__graft_entry__.dryrun_multichip``
  (:103-273) over ``torch.distributed``: n ranks (spawned here unless a
  process group exists), dp x tp with tp = 2 when n >= 4 and n is even;
  training steps of a small speaker CE model with ``accumulate_steps=2``,
  the backbone frozen for the first and released for a second (whose
  gradients it returns gathered), the sharded embedding extraction and
  CTC logits, and a checkpoint saved from the dp x tp state and restored
  onto dp = n / 2 (no TP) for one more step.

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
    "synthetic_batch", "dryrun_multichip", "DRYRUN_TINY", "NUM_SPEAKERS", "BATCH", "SAMPLES",
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


# __graft_entry__.py's tiny backbone (:130-140): 4 heads of 8
DRYRUN_TINY = Wav2Vec2Config(
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)


def dryrun_multichip(
    n: int, device: DeviceLike = None, w2v2: Optional[Wav2Vec2Config] = None, samples: int = 800,
    rows: Optional[int] = None, state_dict: Optional[Dict[str, torch.Tensor]] = None,
    backend: Optional[str] = None, deadline: Optional[float] = None,
) -> Dict:
    """The multi-rank path end to end on ``n`` ranks; returns rank 0's
    report: ``kind`` ("dp=D x tp=T"), the first step's ``loss`` (the
    backbone frozen), ``layers_run`` (the mean of both microbatches' kept
    layers), the attention kernels' ``step_launches`` on rank 0 and its
    ``local_heads``, the second step's ``released_loss`` (the backbone
    released) and ``grads`` (every gradient gathered whole), the shapes of
    the sharded ``embeddings`` and CTC ``logits``, ``restored_onto`` (the
    data ranks of the restore) and ``restored_loss``, each loss finite
    (else it raises), and ``gathered``: the model's ``state_dict``
    gathered back from its TP shards before the first step.

    ``w2v2`` is the backbone (``DRYRUN_TINY`` by default; on the card the
    kernels take heads of 64 only, so give it one such), ``samples`` the
    clip length, ``rows`` the global batch (2 n by default, as the JAX
    twin's), ``state_dict`` weights to load before sharding (else drawn
    from seed 0). Without a process group the ``n`` ranks are spawned
    here (``parallel.mesh.spawn`` with ``backend`` and ``deadline``: gloo
    on the CPU; on the card NCCL with a card a rank, or gloo, which lets
    ranks share one card)."""
    from .models.wav2vec2_speech import Wav2Vec2SpeechConfig, Wav2Vec2SpeechModel
    from .data.tokenizer import CharTokenizer
    from .parallel import tp
    from .parallel.mesh import broadcast_object, create_mesh, needs_spawn, select_rows, shard_map_rows, spawn, sub_mesh
    from .train.checkpoint import CheckpointManager
    from .train.speech_task import SpeechTask
    from .train.state import AdamTx, make_freeze_schedule_tx

    requested = torch.device("cuda" if device is None else device)
    if needs_spawn(n):
        return spawn(dryrun_multichip, (n, device, w2v2, samples, rows, state_dict), nprocs=n,
                     device=requested.type, backend=backend, deadline=deadline,
                     threads=max(torch.get_num_threads() // n, 1))
    dev = resolve_device(device)
    use_tp = n >= 4 and n % 2 == 0
    mesh = create_mesh(n, model=2 if use_tp else 1, device=dev)
    dev = mesh.device
    w2v2 = DRYRUN_TINY if w2v2 is None else w2v2
    cfg = Wav2Vec2SpeakerConfig(w2v2=w2v2, stat_pooling_type="mean")
    if dev.type == "cuda":
        set_float32_precision()
    with torch.device("meta"):
        model = Wav2Vec2SpeakerModel(cfg, num_speakers=16)
    model.to_empty(device=dev)
    if state_dict is None:
        init_parameters(model, torch.Generator(device=dev).manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    task = SpeakerTask(model, "ce")

    b = 2 * n if rows is None else rows
    rng = np.random.default_rng(0)
    batch = {"features": rng.normal(size=(b, samples)).astype(np.float32), "mask": np.ones((b, samples), bool),
             "labels": rng.integers(0, 16, size=b)}

    def on_device(x):
        return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}

    tp.shard_model(model, mesh)
    gathered = tp.gather_state_dict(model, mesh)

    def frozen_adam():  # the real trainer path: a backbone released by step count
        return make_freeze_schedule_tx(AdamTx(lambda count: 1e-3), lambda p: p.startswith("wav2vec2"), 1)

    from .ops import flash_attention as fa

    state = TrainState.create(model, frozen_adam(), seed=1)
    step = make_train_step(task, accumulate_steps=2, mesh=mesh)
    before = fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches
    state, metrics = step(state, on_device(select_rows(batch, mesh, acc=2)))
    launched = [a - b for a, b in zip((fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
                                       fa.flash_attention_bwd_dkv.launches), before)]
    loss = float(metrics["loss"])
    # a second step with the backbone released: the TP collectives'
    # backward and the data-group reduce of the sharded gradients feed
    # every gradient, returned gathered whole
    state, released = step(state, on_device(select_rows(batch, mesh, acc=2)))
    released_loss, grads = float(released["loss"]), tp.gather_grads(model, mesh)
    if not np.isfinite([loss, released_loss]).all():
        raise FloatingPointError(f"non-finite loss {loss}, {released_loss}")

    # the sharded eval paths, on the whole model over every rank as data
    dp = create_mesh(n, model=1, device=dev) if use_tp else mesh
    with torch.device("meta"):
        full = Wav2Vec2SpeakerModel(cfg, num_speakers=16)
    full.to_empty(device=dev).load_state_dict(tp.gather_state_dict(model, mesh))
    full.eval()
    with torch.inference_mode():
        emb = shard_map_rows(lambda x: full.compute_embedding(*on_device(x).values()), {
            "features": batch["features"], "mask": batch["mask"]}, dp).cpu().numpy()
    if emb.shape[0] != b or not np.isfinite(emb).all():
        raise FloatingPointError(f"sharded embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    tok = CharTokenizer.build(["abc d"])
    with torch.device("meta"):
        smodel = Wav2Vec2SpeechModel(Wav2Vec2SpeechConfig(w2v2=w2v2, vocab_size=tok.vocab_size))
    smodel.to_empty(device=dev)
    init_parameters(smodel, torch.Generator(device=dev).manual_seed(2))
    stask = SpeechTask(smodel.eval(), tok)
    with torch.inference_mode():
        logits, lengths = shard_map_rows(lambda x: stask.logits_fn(*on_device(x).values()), {
            "features": batch["features"], "mask": batch["mask"]}, dp, mask_fill=True)
    if not torch.isfinite(logits).all() or tuple(lengths.shape) != (b,):
        raise FloatingPointError(f"sharded CTC logits {tuple(logits.shape)}, lengths {tuple(lengths.shape)}")

    # the dp x tp state saved whole, restored onto dp = n / 2 without TP,
    # one more step there
    import tempfile

    import torch.distributed as dist

    half = sub_mesh(mesh, max(n // 2, 1))
    tree = tp.gather_tree(state.state_dict(), model, mesh)
    with tempfile.TemporaryDirectory() as td:
        td = broadcast_object(td, mesh)  # rank 0's directory
        CheckpointManager(td, mesh=mesh).save_step(_Saved(tree), {"val_eer": 0.5})
        restored_loss = None
        if half is not None:
            with torch.device("meta"):
                again = Wav2Vec2SpeakerModel(cfg, num_speakers=16)
            again.to_empty(device=dev)
            template = TrainState.create(again, frozen_adam(), seed=1)
            restored = CheckpointManager(td, mesh=half).restore(template, name="last")
            if restored.step != state.step:
                raise RuntimeError(f"restored step {restored.step} != {state.step}")
            step_half = make_train_step(SpeakerTask(again, "ce"), accumulate_steps=2, mesh=half)
            restored, rmetrics = step_half(restored, on_device(select_rows(batch, half, acc=2)))
            restored_loss = float(rmetrics["loss"])
            if not np.isfinite(restored_loss):
                raise FloatingPointError(f"non-finite post-restore loss {restored_loss}")
        if mesh.distributed:
            dist.barrier(group=mesh.host_group)  # no rank removes the directory under another
    kind = f"dp={mesh.data} x tp={mesh.model}"
    if mesh.is_main:
        print(f"dryrun_multichip({n}): ok ({kind}), loss={loss:.4f}, released={released_loss:.4f}, sharded eval "
              f"ok (embed {emb.shape}, ctc logits {tuple(logits.shape)}), ckpt round-trip ok (restored onto "
              f"dp={max(n // 2, 1)}, "
              f"post-restore loss={restored_loss:.4f})", flush=True)
    return {"kind": kind, "loss": loss, "released_loss": released_loss, "grads": grads,
            "embeddings": emb.shape, "logits": tuple(logits.shape),
            "restored_onto": max(n // 2, 1), "restored_loss": restored_loss, "gathered": gathered,
            "layers_run": float(metrics["layers_run"]), "step_launches": launched,
            "local_heads": model.wav2vec2.encoder.layers[0].attention.num_heads}


class _Saved:
    """A ``TrainState`` stand-in that hands the checkpoint manager a
    gathered ``state_dict``."""

    def __init__(self, tree: Dict):
        self.tree, self.step = tree, tree["step"]

    def state_dict(self) -> Dict:
        return self.tree
