"""Recipe assembly: the backbone config, the speaker model and task, and the
optimizer from a config dict.

Counterpart of ``w2v2_speaker_tpu/runtime/experiment.py``: ``_w2v2_config``
(:320) as ``w2v2_config``, ``build_model_and_task`` (:374) for the
``wav2vec2_fc`` network in the ``ce`` and ``aam`` modes, and
``build_optimizer`` (:616) for Adam under the one-cycle schedule,
global-norm clipping and the backbone freeze schedules, and
``build_evaluator`` (:289) for the five evaluators of ``config/evaluator/``,
read from the same keys of the merged Hydra config (``optim.algo``,
``optim.schedule``, ``optim.loss``, ``trainer``, ``network``,
``evaluator``). ``load_recipe`` composes a recipe from ``config/`` with
the port's ``load_config``. What is not ported raises
``NotImplementedError`` naming its ROADMAP row.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Sequence, Tuple

from ..eval.backends import LDAEvaluator, PLDAEvaluator
from ..eval.evaluator import (
    ASNormCosineEvaluator, CosineDistanceEvaluator, SpeakerRecognitionEvaluator,
)
from ..models.wav2vec2 import BASE_CONFIG, LARGE_CONFIG, Wav2Vec2Config
from ..models.wav2vec2_speaker import Wav2Vec2SpeakerConfig, Wav2Vec2SpeakerModel
from ..objectives import schedules
from ..train.speaker_task import SpeakerTask
from ..train.state import AdamTx, ClipTx, make_freeze_schedule_tx
from .config import load_config

__all__ = [
    "CONFIG_DIR", "TINY_W2V2", "build_evaluator", "build_model_and_task", "build_optimizer",
    "load_recipe", "speaker_model_config", "w2v2_config",
]

_OPTIM_ROW = "ROADMAP.md Queue 1 item 3 (optimizers and schedules)"
CONFIG_DIR = pathlib.Path(__file__).resolve().parents[2] / "config"

TINY_W2V2 = Wav2Vec2Config(  # network.wav2vec2_size=tiny (:82), for debug runs
    conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=48, num_layers=2,
    num_heads=4, intermediate_size=96, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)

def load_recipe(experiment: str, overrides: Sequence[str] = ()) -> Dict:
    """The merged config of ``+experiment=<experiment>`` over
    ``config/train_eval.yaml``, then ``overrides``, composed as ``run.py``
    composes it."""
    return load_config(CONFIG_DIR, "train_eval", [f"+experiment={experiment}", *overrides])


def _canon_int8(val):
    """``network.int8_matmuls`` as the JAX package reads it (:786): YAML's
    1 / 0 arrive as ints, and 1 must mean true."""
    if isinstance(val, str):
        return val
    return bool(val)


def w2v2_config(net: Dict, precision: str, remat: bool = False, accumulate: int = 1) -> Wav2Vec2Config:
    """The backbone config of a ``network`` dict, key for key and default for
    default as the JAX ``_w2v2_config`` (:320) builds it: BASE, LARGE or
    tiny with the recipe's regularisation, computing in bfloat16 for
    precision "bf16". ``remat``, ``remat_policy``, ``encoder_unroll``,
    ``posconv_decomposed`` and ``attention_impl`` are carried and validated
    and change nothing here (ROADMAP Queue 1 item 9); ``int8_matmuls``
    true makes the model raise."""
    base = {"base": BASE_CONFIG, "large": LARGE_CONFIG, "tiny": TINY_W2V2}[
        net.get("wav2vec2_size", "base")]
    keys = ("activation_dropout", "attention_dropout", "feat_proj_dropout", "hidden_dropout",
            "layerdrop", "mask_feature_length", "mask_feature_prob", "mask_time_length",
            "mask_time_prob")
    return Wav2Vec2Config(**{
        **base.__dict__,
        "posconv_decomposed": net.get("posconv_decomposed", accumulate > 1),
        **{k: net[k] for k in keys},
        "dtype": "bfloat16" if precision == "bf16" else "float32",
        "remat": remat,
        "remat_policy": net.get("remat_policy", "nothing"),
        "attention_impl": net.get("attention_impl", "xla"),
        "conv_impl": net.get("conv_impl", "xla"),
        "encoder_unroll": net.get("encoder_unroll", 1),
        "int8_matmuls": _canon_int8(net.get("int8_matmuls", False)) is True,
        "hash_dropout": net.get("hash_dropout", True),
    })


_MODES = {"cross_entropy": "ce", "aam_softmax": "aam"}


def speaker_model_config(cfg: Dict) -> Tuple[Wav2Vec2SpeakerConfig, str]:
    """(model config, training mode) of a merged config whose network is
    ``wav2vec2_fc`` and whose loss is cross entropy or AAM softmax, as the
    JAX ``build_model_and_task`` (:434-459) reads them."""
    net, loss = cfg["network"], cfg["optim"]["loss"]
    if net.get("name", "wav2vec2_fc") != "wav2vec2_fc":
        raise NotImplementedError(f"network {net['name']!r} is not ported yet: ROADMAP.md Queue 1 item 7")
    if loss["name"] not in _MODES:
        raise NotImplementedError(f"loss {loss['name']!r} is not ported yet: ROADMAP.md Queue 1 item 7")
    trainer = cfg["trainer"]
    w2v2 = w2v2_config(net, trainer["precision"], trainer.get("remat", False),
                       int(trainer.get("accumulate_grad_batches") or 1))
    use_aam = loss["name"] == "aam_softmax"
    model_cfg = Wav2Vec2SpeakerConfig(
        w2v2=w2v2,
        feature_encoder_only=net.get("wav2vec_feature_encoder_only", False),
        stat_pooling_type=net["stat_pooling_type"],
        test_stat_pooling_type=net.get("test_stat_pooling_type"),
        hidden_fc_layers_out=tuple(net["hidden_fc_layers_out"]),
        embedding_layer_idx=net["embedding_layer_idx"],
        use_aam=use_aam,
        aam_margin=loss.get("margin", 0.2),
        aam_scale=loss.get("scale", 30.0),
        final_channel_mask_prob=net["final_channel_mask_prob"],
        final_channel_mask_width=net["final_channel_mask_width"],
    )
    mode = _MODES[loss["name"]]
    if mode == "ce" and net["stat_pooling_type"] == "none":
        mode = "ce_no_pool"
    return model_cfg, mode


def build_model_and_task(cfg: Dict, num_speakers: int) -> Tuple[SpeakerTask, str]:
    """``(task, "speaker")`` with a new ``Wav2Vec2SpeakerModel`` (parameters
    allocated, not initialised: see ``models.wav2vec2.init_parameters``)
    over ``network.explicit_num_speakers`` or ``num_speakers`` classes."""
    model_cfg, mode = speaker_model_config(cfg)
    n_out = cfg["network"].get("explicit_num_speakers") or num_speakers
    return SpeakerTask(Wav2Vec2SpeakerModel(model_cfg, num_speakers=n_out), mode), "speaker"


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


def build_evaluator(cfg: Dict) -> SpeakerRecognitionEvaluator:
    """The evaluator of ``cfg["evaluator"]`` (any file of
    ``config/evaluator/``), with the JAX package's defaults (:289-318)."""
    e = cfg["evaluator"]
    if e["name"] == "cosine_distance":
        return CosineDistanceEvaluator(
            center_before_scoring=e["center_before_scoring"],
            length_norm_before_scoring=e["length_norm_before_scoring"],
            max_num_training_samples=e["max_num_training_samples"],
        )
    if e["name"] == "cosine_distance_asnorm":
        return ASNormCosineEvaluator(
            cohort_topk=int(e.get("cohort_topk", 300)),
            center_before_scoring=e.get("center_before_scoring", False),
            length_norm_before_scoring=e.get("length_norm_before_scoring", True),
            max_num_training_samples=e["max_num_training_samples"],
        )
    if e["name"] == "lda":
        return LDAEvaluator(
            num_pca_components=e["num_pca_components"],
            max_num_training_samples=e["max_num_training_samples"],
        )
    if e["name"] == "plda":
        return PLDAEvaluator(
            num_pca_components=e["num_pca_components"],
            num_em_iterations=e["num_em_iterations"],
            max_num_training_samples=e["max_num_training_samples"],
        )
    raise ValueError(f"unknown evaluator {e['name']}")
