"""Recipe assembly: the backbone config and the optimizer from a config dict.

Counterpart of ``w2v2_speaker_tpu/runtime/experiment.py``: ``_w2v2_config``
(:320) as ``w2v2_config`` and ``build_optimizer`` (:616), for the subset
the ``speaker_wav2vec2_ce`` recipe uses: Adam under the one-cycle schedule,
global-norm clipping and the backbone freeze schedules, read from the same
keys of the merged Hydra config (``optim.algo``, ``optim.schedule``,
``trainer``, ``network``). What is not ported raises
``NotImplementedError`` naming its ROADMAP row. ``SPEAKER_WAV2VEC2_CE`` is
that recipe's merged config, restricted to the keys read here (the port
carries no YAML reader; ``tests/test_torch_train_step.py`` holds it
against ``config/``).
"""

from __future__ import annotations

from typing import Dict

from ..models.wav2vec2 import BASE_CONFIG, LARGE_CONFIG, Wav2Vec2Config
from ..objectives import schedules
from ..train.state import AdamTx, ClipTx, make_freeze_schedule_tx

__all__ = ["SPEAKER_WAV2VEC2_CE", "build_optimizer", "w2v2_config"]

_OPTIM_ROW = "ROADMAP.md Queue 1 item 5 (optimizers and schedules)"

# config/experiment/speaker_wav2vec2_ce.yaml over config/train_eval.yaml's
# defaults: network wav2vec2_fc, optim/algo adam (lr 9e-5), optim/schedule
# one_cycle, optim/loss cross_entropy, trainer (bf16, 100 000 steps, 4 steps
# per dispatch), batch 66
SPEAKER_WAV2VEC2_CE: Dict = {
    "network": {
        "wav2vec2_size": "base",
        "wav2vec_initially_frozen": False,
        "num_frozen_steps": None,
        "completely_freeze_feature_extractor": False,
        "hidden_fc_layers_out": [],
        "embedding_layer_idx": -1,
        "stat_pooling_type": "mean",
        "test_stat_pooling_type": None,
        "activation_dropout": 0.0,
        "attention_dropout": 0.1,
        "feat_proj_dropout": 0.1,
        "hidden_dropout": 0.1,
        "layerdrop": 0.05,
        "mask_feature_length": 10,
        "mask_feature_prob": 0.0,
        "mask_time_length": 10,
        "mask_time_prob": 0.05,
        "final_channel_mask_prob": 0.0,
        "final_channel_mask_width": 1,
    },
    "optim": {
        "algo": {"name": "adam", "lr": 9.0e-5, "b1": 0.9, "b2": 0.999,
                 "weight_decay": 0.0, "mu_dtype": None},
        "schedule": {"name": "one_cycle", "pct_start": 0.3, "div_factor": 25.0,
                     "final_div_factor": 10000.0},
        "loss": {"name": "cross_entropy"},
    },
    "trainer": {"max_steps": 100000, "precision": "bf16", "accumulate_grad_batches": 1,
                "gradient_clip_val": 0, "steps_per_dispatch": 4},
    "data": {"dataloader": {"batch_size": 66}},
}


def w2v2_config(net: Dict, precision: str) -> Wav2Vec2Config:
    """The backbone config of a ``network`` dict: BASE or LARGE with the
    recipe's regularisation, computing in bfloat16 for precision "bf16"."""
    base = {"base": BASE_CONFIG, "large": LARGE_CONFIG}[net.get("wav2vec2_size", "base")]
    keys = ("activation_dropout", "attention_dropout", "feat_proj_dropout", "hidden_dropout",
            "layerdrop", "mask_feature_length", "mask_feature_prob", "mask_time_length",
            "mask_time_prob")
    return Wav2Vec2Config(**{
        **base.__dict__,
        **{k: net[k] for k in keys},
        "dtype": "bfloat16" if precision == "bf16" else "float32",
        "hash_dropout": net.get("hash_dropout", True),
    })


def build_optimizer(cfg: Dict):
    """The update transform of a merged config: Adam under one-cycle,
    optional global-norm clipping, then the freeze schedules, composed in
    the order of the JAX ``build_optimizer``."""
    algo = cfg["optim"]["algo"]
    sched_cfg = cfg["optim"]["schedule"]
    if algo["name"] != "adam":
        raise NotImplementedError(f"optimizer {algo['name']!r} is not ported yet: {_OPTIM_ROW}")
    if algo.get("weight_decay"):
        raise NotImplementedError(f"adam weight_decay (adamw) is not ported yet: {_OPTIM_ROW}")
    if algo.get("mu_dtype"):
        raise NotImplementedError(f"adam mu_dtype is not ported yet: {_OPTIM_ROW}")
    if sched_cfg["name"] != "one_cycle":
        raise NotImplementedError(f"schedule {sched_cfg['name']!r} is not ported yet: {_OPTIM_ROW}")
    sched = schedules.one_cycle(
        max_lr=algo["lr"],
        total_steps=cfg["trainer"]["max_steps"],
        pct_start=sched_cfg["pct_start"],
        div_factor=sched_cfg["div_factor"],
        final_div_factor=sched_cfg["final_div_factor"],
    )
    tx = AdamTx(sched, b1=algo["b1"], b2=algo["b2"])
    clip_val = float(cfg["trainer"].get("gradient_clip_val") or 0)
    if clip_val > 0:
        tx = ClipTx(tx, clip_val)
    net = cfg["network"]
    if net.get("wav2vec_initially_frozen"):
        tx = make_freeze_schedule_tx(
            tx,
            frozen_predicate=lambda p: p.startswith(
                ("wav2vec2", "feature_encoder", "feature_projection", "encoder")
            ),
            num_frozen_steps=net.get("num_frozen_steps"),
        )
    if net.get("completely_freeze_feature_extractor"):
        tx = make_freeze_schedule_tx(
            tx, frozen_predicate=lambda p: "feature_encoder" in p, num_frozen_steps=None
        )
    return tx
