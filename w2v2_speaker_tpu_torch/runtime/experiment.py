"""Recipe assembly and the train/validate/test loop of the speaker, paired,
speech and multitask recipes.

Counterpart of ``w2v2_speaker_tpu/runtime/experiment.py``: ``_w2v2_config``
(:320) as ``w2v2_config``, ``build_model_and_task`` (:374) for the
``wav2vec2_fc`` network in the ``ce``, ``aam``, ``ce_no_pool``, ``triplet``,
``triplet_ce`` and ``speaker_ctc`` modes (:434-459), the ``wav2vec2_paired``
network (:513-522), the ``wav2vec2_multitask`` network (:524-574) and the
``wav2vec2_fc_letter`` speech network (:576-593), the ``xvector``,
``ecapa_tdnn``, ``wav2spk`` and ``dummy`` networks (:393-476; the first
two behind the fbank frontend, all four computing in float32 whatever
``trainer.precision`` says, as the JAX package builds them without a
dtype), and ``build_optimizer`` (:616) for Adam (AdamW with a weight
decay, the first moment in ``mu_dtype``) or SGD with momentum under every
schedule of ``config/optim/schedule/`` (``_normalize_schedule_cfg`` :596
folds the reference's nested schedule keys), global-norm clipping and the
backbone freeze schedules,
and ``build_evaluator`` (:289) for the five evaluators of
``config/evaluator/``, read from the same keys of the merged Hydra config
(``optim.algo``, ``optim.schedule``, ``optim.loss``, ``trainer``,
``network``, ``evaluator``). ``load_recipe`` composes a recipe from
``config/`` with the port's ``load_config``. The ``wav2vec_fc`` and
``wav2vec_xvector`` networks (wav2vec v1, :479-511) compute their encoder
in bfloat16 under ``trainer.precision=bf16`` and their heads in float32.
``build_augmenter`` (:97) chains the waveform effects of
``data.pipeline.augment`` for the VoxCeleb training pipeline.

The entry point is ``run_train_eval`` (:840) on one card: the data module
(``build_data_module`` :198, VoxCeleb or LibriSpeech), the model and its
weights (``_init_state`` :983), the training loop (``_train_loop`` :1094:
steps per dispatch, accumulation, sanity and interval validations, best-k
and last checkpoints, resume, early stopping, step and epoch limits; the
batches of a failed step dumped under ``debug_batch/train_step`` before the
error goes on), then the best checkpoint (or the average of the best k) on
the test split:
embeddings of full utterances scored by the evaluator (``_run_speaker``
:1469; the triplet modes train on ``TripletBatchProcessor`` batches, and
``use_transformers_as_ensembles`` scores the mean over per-layer
embeddings), the paired network's sigmoid score of each full-utterance
pair (``_run_paired`` :1704), the WER of greedy CTC transcriptions of the
clean and other test splits (``_run_speech`` :1874, which checkpoints on
``val_wer`` and logs a tracked training utterance's transcription at each
validation), or both WERs and the cosine EER of speaker trials over the
first test split (``_run_multitask`` :1949, which checkpoints on
``val_eer``, as the JAX package's ``_train_loop`` :1129 does for every kind
but speech). It runs on the card unless called with ``device="cpu"``.
What is not ported raises ``NotImplementedError`` naming its ROADMAP row.
``run_lr_range_test`` / ``tune_model`` run the LR range test of
``runtime/lr_find.py`` instead of training and return its suggestion
(:950-970). Under ``reduce_on_plateau`` the loop feeds each validation's
``val_eer`` (``val_wer`` for speech) to the schedule's controller and
prints ``plateau: effective lr -> ...`` when the factor moves (:1281-1300);
the sanity validation never moves it. ``callbacks.progress_tracker``
snapshots a probe set's embeddings at each validation of every
speaker-family network (``runtime/progress.py``, :1480-1500).
The debug surface of ``runtime/debug.py``: ``trainer.dump_first_batch``
dumps the first collated training batch under ``first_batch`` beside the
checkpoint directory and installs a ``PipelineDebugCapture`` in the data
module (``callbacks.input_monitor.out_dir`` and ``max_samples``, 0 for
none, :903-928); ``verify_model`` prints ``model_summary`` and runs the
cross-batch leakage probe on the example batch in eval mode (:1007-1019).
As the JAX package does, the speaker and paired runs draw that example
batch (the first training batch) before training, where something reads
it or its draw moves state that training reads: the verification, the
capture (which records the first samples in that draw) and an augmenter
(whose generators the draw advances). With more training samples than
the batch processor's queue holds, the number of samples that draw
augments depends on how far the prefetch thread ran, in both packages.

The TPU-era run knobs take these meanings here (the JAX package's are at
:851-870, :1172-1251 and :1327-1331):

- ``trainer.deterministic=true``: ``torch.use_deterministic_algorithms``
  (never ``warn_only``) with cuDNN's deterministic algorithms and no
  benchmark, for the run, the previous state restored after it; on the
  card, ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set in the environment before
  the process's first CUDA work (or the run raises: cuBLAS sizes its
  workspace when its handle is made). The hand-written kernels are
  deterministic already (one writer per output tile, counter-hash
  masks, the CTC forward-backward of ``ops/ctc.py`` without atomics), so
  every recipe trains under it, the CTC ones too. (The JAX package makes
  the knob a no-op: XLA is deterministic.)
- ``profiler=simple|advanced|jax_trace`` (``name: jax_trace``): a
  ``torch.profiler`` window (CPU, and CUDA on the card) over the steps
  ``[start_step, start_step + num_steps)``, each dispatch a
  ``train_step_<n>`` (or ``train_steps_<a>-<b>``) range, written as a Chrome trace to
  ``<trace_dir>/trace.json``; dispatches never straddle the window, and
  the window zeroes ``num_sanity_val_steps``.
- ``trainer.remat``: each kept encoder layer of a training forward under
  ``torch.utils.checkpoint``, recomputed whole in the backward
  (``models/wav2vec2.py``). ``network.remat_policy`` is validated and
  changes nothing beyond that: every policy recomputes the whole layer.
- No-ops, read and documented: ``network.encoder_unroll`` (a Python loop
  of layers stands in for ``nn.scan``), ``network.attention_impl`` (every
  attention call takes the hand-written kernel), ``network.posconv_decomposed``,
  ``trainer.prng_impl`` (a TPU PRNG choice) and the compile cache
  (``W2V2_COMPILE_CACHE``): the port compiles nothing but its kernels,
  which ``ops/_build.py`` caches by the hash of their sources.

``network.int8_matmuls``: true serves the wav2vec2 dense sites in int8 and
is refused in a run that trains (``_validate_int8_config``), so it runs
with ``fit_model=false``; auto trains and tests in full precision (only
predict dispatches per bucket).

Random draws come from torch generators: the initial weights from one seeded with
``seed`` on the device, the train step's draws from a CPU one seeded with
``seed + 1`` (the JAX package keys its init with ``PRNGKey(seed)`` and its
steps with ``PRNGKey(seed + 1)``), so the two packages agree on a run only
from the same weights (``load_network_from_checkpoint``) with dropout,
layerdrop and masking at 0. The epoch-in-progress save of the JAX
package (``_train_loop`` :1287, whose resumed run retrains the epoch it
was saved in) is carried over unchanged. The triplet losses read
``optim.loss.margin``, ``c_ce`` and ``c_triplet``, which the JAX package's
``build_model_and_task`` (:459) leaves at the task's defaults whatever the
config says (the shipped values are those defaults). The checkpoints of
a ``reduce_on_plateau`` run carry the controller's state (best metric,
validations without improvement, factor), updated before the save, so a
resumed run goes on at the same rate; the JAX package's controller starts
afresh on resume and resets the injected rate to the base rate at its
first validation.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
import time
from types import SimpleNamespace
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.augment import (
    Augmenter, ChoiceRandomNoiseAugment, ChoiceRirsNoiseAugment, ChoiceSpeedAugment, FrequencyDropoutAugment,
    ReverbAugment, SpecAugmentTimeDomain, TimeDropoutAugment, UniformSpeedAugment,
)
from ..data.batching import PairedBatchProcessor, TripletBatchProcessor
from ..data.collate import pad_batch_rows
from ..data.features import FbankConfig
from ..data.datamodule import VoxCelebConfig, VoxCelebDataModule
from ..data.librispeech import LibriSpeechConfig, LibriSpeechDataModule
from ..data.samples import collate_paired_batch, collate_speaker_batch
from ..data.tokenizer import CharTokenizer
from ..device import DeviceLike, resolve_device, set_float32_precision
from ..eval.backends import LDAEvaluator, PLDAEvaluator
from ..eval.evaluator import (
    ASNormCosineEvaluator, CosineDistanceEvaluator, EmbeddingSample, SpeakerRecognitionEvaluator,
)
from ..models.dummy import DummyModel
from ..models.ecapa import EcapaConfig, EcapaModel
from ..models.frontend import FbankFrontend
from ..models.hf_convert import load_hf_checkpoint
from ..models.wav2spk import Wav2SpkConfig, Wav2SpkModel
from ..models.wav2vec1 import Wav2Vec1Config, Wav2Vec1FCModel, Wav2Vec1XVectorModel
from ..models.wav2vec2 import BASE_CONFIG, LARGE_CONFIG, Wav2Vec2Config, init_parameters
from ..models.wav2vec2_multitask import Wav2Vec2MultitaskConfig, Wav2Vec2MultitaskModel
from ..models.wav2vec2_paired import Wav2Vec2PairedConfig, Wav2Vec2PairedModel
from ..models.wav2vec2_speaker import Wav2Vec2SpeakerConfig, Wav2Vec2SpeakerModel
from ..models.wav2vec2_speech import Wav2Vec2SpeechConfig, Wav2Vec2SpeechModel
from ..models.xvector import XVectorConfig, XVectorModel
from ..objectives import schedules
from ..parallel.mesh import (
    broadcast_object, check_cards, create_mesh, current_mesh, needs_spawn, resolve_num_devices,
    select_rows, shard_map_rows, shared_iter, spawn, use_mesh,
)
from ..train.checkpoint import CheckpointManager, graft_into, load_params
from ..train.multitask_task import MultitaskTask
from ..train.paired_task import PairedSpeakerTask, paired_scores_to_metrics
from ..train.speaker_task import SpeakerTask
from ..train.speech_task import SpeechTask
from ..train.state import AdamTx, ClipTx, SgdTx, TrainState, find_schedule, make_freeze_schedule_tx
from ..train.steps import make_train_step
from .config import load_config
from .debug import PipelineDebugCapture, batch_gradient_verification, dump_first_batch, model_summary
from .logging import MetricsLogger

__all__ = [
    "CONFIG_DIR", "TINY_W2V2", "EarlyStopping", "build_augmenter", "build_data_module", "build_evaluator",
    "build_model_and_task", "build_optimizer", "graft_pretrained", "load_recipe", "multitask_model_config",
    "paired_model_config", "run_train_eval", "speaker_model_config", "speech_model_config", "w2v2_config",
]

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
    ``posconv_decomposed`` and ``attention_impl`` are carried and validated;
    ``remat`` checkpoints the encoder layers (under any ``remat_policy``) and
    ``int8_matmuls`` true (YAML's 1 too) makes the dense sites int8, and
    the other three change nothing here (the module's docstring)."""
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


_MODES = {"cross_entropy": "ce", "aam_softmax": "aam", "triplet": "triplet", "triplet_ce": "triplet_ce",
          "ctc": "speaker_ctc"}


def speaker_model_config(cfg: Dict) -> Tuple[Wav2Vec2SpeakerConfig, str]:
    """(model config, training mode) of a merged config whose network is
    ``wav2vec2_fc`` and whose loss is cross entropy, AAM softmax, triplet,
    triplet + CE or CTC, as the JAX ``build_model_and_task`` (:434-459)
    reads them: CTC adds the blank class with a bias of 100, and cross
    entropy with ``stat_pooling_type`` ``none`` is the frame-level
    ``ce_no_pool``."""
    net, loss = cfg["network"], cfg["optim"]["loss"]
    if net.get("name", "wav2vec2_fc") != "wav2vec2_fc":
        raise ValueError(f"network {net['name']!r} is not wav2vec2_fc: build_model_and_task builds it")
    if loss["name"] not in _MODES:  # the JAX package's mode table raises KeyError
        raise ValueError(f"loss {loss['name']!r} is not a loss of the wav2vec2_fc network")
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
        ctc_head=loss["name"] == "ctc",
        ctc_blank_bias=100.0 if loss["name"] == "ctc" else 0.0,
    )
    mode = _MODES[loss["name"]]
    if mode == "ce" and net["stat_pooling_type"] == "none":
        mode = "ce_no_pool"
    return model_cfg, mode


def _speaker_task(cfg: Dict, model, mode: str) -> SpeakerTask:
    """The speaker task of ``mode``; the triplet modes read the loss
    config's ``margin``, ``c_ce`` and ``c_triplet`` (the JAX package keeps
    the task's defaults, 1.0, whatever they say: ROADMAP Queue 3)."""
    loss = cfg["optim"]["loss"]
    if mode not in ("triplet", "triplet_ce"):
        return SpeakerTask(model, mode)
    return SpeakerTask(model, mode, triplet_margin=float(loss.get("margin", 1.0)),
                       c_ce=float(loss.get("c_ce", 1.0)), c_triplet=float(loss.get("c_triplet", 1.0)))


_OWN_FAMILIES = ("xvector", "ecapa_tdnn", "wav2spk", "dummy", "wav2vec_fc", "wav2vec_xvector")  # off wav2vec2


def _xvector_config(net: Dict, in_channels: int) -> XVectorConfig:
    return XVectorConfig(in_channels=in_channels, tdnn_channels=tuple(net["tdnn_channels"]),
                         tdnn_kernel_sizes=tuple(net["tdnn_kernel_sizes"]),
                         tdnn_dilations=tuple(net["tdnn_dilations"]), lin_neurons=net["lin_neurons"])


def _family_model(cfg: Dict, n_out: int):
    """The ``xvector``, ``ecapa_tdnn``, ``wav2spk``, ``dummy``,
    ``wav2vec_fc`` or ``wav2vec_xvector`` model of ``cfg`` over ``n_out``
    classes, key for key as the JAX branches (:393-511) build it, with
    their ``ValueError`` for AAM under x-vector and wav2spk. The first TDNN
    of ``xvector`` reads ``network.n_mels`` features (flax infers its input
    width; ``in_channels`` is no layer's size there); the wav2vec v1
    encoder computes in bfloat16 under ``trainer.precision=bf16``."""
    net, loss = cfg["network"], cfg["optim"]["loss"]
    name, aam = net["name"], loss["name"] == "aam_softmax"
    if aam and name in ("xvector", "wav2spk"):
        raise ValueError(f"{name} does not support aam softmax")
    if name == "xvector":
        inner = XVectorModel(_xvector_config(net, net["n_mels"]), num_speakers=n_out)
        return FbankFrontend(inner, FbankConfig(n_mels=net["n_mels"]))
    if name in ("wav2vec_fc", "wav2vec_xvector"):
        v1 = Wav2Vec1Config(use_aggregator=net.get("use_aggregation_layers", False),
                            dtype="bfloat16" if cfg["trainer"]["precision"] == "bf16" else "float32")
        if name == "wav2vec_xvector":
            return Wav2Vec1XVectorModel(v1, _xvector_config(net, 512), num_speakers=n_out)
        return Wav2Vec1FCModel(v1, stat_pooling_type=net["stat_pooling_type"],
                               hidden_fc_layers_out=tuple(net["hidden_fc_layers_out"]),
                               embedding_layer_idx=net["embedding_layer_idx"], num_speakers=n_out)
    if name == "ecapa_tdnn":
        inner = EcapaModel(EcapaConfig(
            in_channels=net["n_mels"], channels=tuple(net["channels"]), kernel_sizes=tuple(net["kernel_sizes"]),
            dilations=tuple(net["dilations"]), attention_channels=net["attention_channels"],
            res2net_scale=net["res2net_scale"], se_channels=net["se_channels"],
            global_context=net["global_context"], lin_neurons=net["lin_neurons"]),
            num_speakers=n_out, use_aam=aam, aam_margin=loss.get("margin", 0.2), aam_scale=loss.get("scale", 30.0))
        return FbankFrontend(inner, FbankConfig(n_mels=net["n_mels"]))
    if name == "wav2spk":
        return Wav2SpkModel(Wav2SpkConfig(
            apply_temporal_gating=net["apply_temporal_gating"],
            hidden_fc_layers_out=tuple(net["hidden_fc_layers_out"]), embedding_layer_idx=net["embedding_layer_idx"],
            stat_pooling_type=net["stat_pooling_type"]), num_speakers=n_out)
    return DummyModel(num_speakers=n_out)


def paired_model_config(cfg: Dict) -> Wav2Vec2PairedConfig:
    """The config of a merged config whose network is ``wav2vec2_paired``
    (:513-521); the loss is BCE whatever ``optim.loss`` names."""
    net, trainer = cfg["network"], cfg["trainer"]
    return Wav2Vec2PairedConfig(
        w2v2=w2v2_config(net, trainer["precision"], trainer.get("remat", False),
                         int(trainer.get("accumulate_grad_batches") or 1)),
        cls_token_constant=net["cls_token_constant"],
        sep_token_constant=net["sep_token_constant"],
    )


def speech_model_config(cfg: Dict, vocab_size: int) -> Wav2Vec2SpeechConfig:
    """The config of a merged config whose network is ``wav2vec2_fc_letter``
    (:576-593), over ``vocab_size`` tokens."""
    net, trainer = cfg["network"], cfg["trainer"]
    return Wav2Vec2SpeechConfig(
        w2v2=w2v2_config(net, trainer["precision"], trainer.get("remat", False),
                         int(trainer.get("accumulate_grad_batches") or 1)),
        vocab_size=vocab_size,
        head_dropout=net["head_dropout"],
        timestep_mask_prob=net["timestep_mask_prob"],
        timestep_mask_width=net["timestep_mask_width"],
        channel_mask_prob=net["channel_mask_prob"],
        channel_mask_width=net["channel_mask_width"],
    )


def multitask_model_config(cfg: Dict, vocab_size: int) -> Wav2Vec2MultitaskConfig:
    """The config of a merged config whose network is ``wav2vec2_multitask``
    (:547-565), over ``vocab_size`` tokens; ``ctc_aam`` adds the AAM head."""
    net, trainer, loss = cfg["network"], cfg["trainer"], cfg["optim"]["loss"]
    return Wav2Vec2MultitaskConfig(
        w2v2=w2v2_config(net, trainer["precision"], trainer.get("remat", False),
                         int(trainer.get("accumulate_grad_batches") or 1)),
        vocab_size=vocab_size,
        head_dropout=net["head_dropout"],
        stat_pooling_type=net["stat_pooling_type"],
        hidden_fc_layers_out=tuple(net["hidden_fc_layers_out"]),
        embedding_layer_idx=net["embedding_layer_idx"],
        use_aam=loss["name"] == "ctc_aam",
        aam_margin=loss.get("margin", 0.2),
        aam_scale=loss.get("scale", 30.0),
    )


def build_model_and_task(
    cfg: Dict, num_speakers: int, tokenizer: Optional[CharTokenizer] = None,
) -> Tuple[Union[SpeakerTask, PairedSpeakerTask, SpeechTask, MultitaskTask], str]:
    """``(task, "speaker")`` with a new ``Wav2Vec2SpeakerModel`` over
    ``network.explicit_num_speakers`` or ``num_speakers`` classes,
    ``(task, "paired")`` with a new ``Wav2Vec2PairedModel`` for the
    ``wav2vec2_paired`` network, ``(task, "speech")`` with a new
    ``Wav2Vec2SpeechModel`` over ``tokenizer``'s vocabulary for the
    ``wav2vec2_fc_letter`` network, or ``(task, "multitask")`` with a new
    ``Wav2Vec2MultitaskModel`` over the speakers and ``tokenizer``'s
    vocabulary (or ``network.explicit_vocab_size`` tokens without one, for
    serving) for the ``wav2vec2_multitask`` network, or ``(task,
    "speaker")`` with the x-vector, ECAPA-TDNN, wav2spk, dummy or wav2vec v1
    model of those networks; parameters allocated, not initialised (see
    ``models.wav2vec2.init_parameters``)."""
    net = cfg["network"]
    name = net.get("name")
    n_out = net.get("explicit_num_speakers") or num_speakers
    if name in _OWN_FAMILIES:
        return _speaker_task(cfg, _family_model(cfg, n_out), _MODES[cfg["optim"]["loss"]["name"]]), "speaker"
    if name == "wav2vec2_paired":
        return PairedSpeakerTask(Wav2Vec2PairedModel(paired_model_config(cfg))), "paired"
    if name == "wav2vec2_fc_letter":
        if tokenizer is None:
            raise ValueError("speech network requires a tokenizer")
        return SpeechTask(Wav2Vec2SpeechModel(speech_model_config(cfg, tokenizer.vocab_size)), tokenizer), "speech"
    if name == "wav2vec2_multitask":
        if tokenizer is None and not net.get("explicit_vocab_size"):
            raise ValueError(
                "multitask network requires a tokenizer (or network.explicit_vocab_size for tokenizer-free "
                "embedding extraction, e.g. predict.py)")
        loss = cfg["optim"]["loss"]
        if loss["name"] not in ("ctc_ce", "ctc_aam"):
            raise ValueError("multitask network requires optim/loss=ctc_ce or ctc_aam")
        vocab = tokenizer.vocab_size if tokenizer is not None else int(net["explicit_vocab_size"])
        model = Wav2Vec2MultitaskModel(multitask_model_config(cfg, vocab), num_speakers=n_out)
        return MultitaskTask(model, tokenizer, mode="aam" if loss["name"] == "ctc_aam" else "ce",
                             speech_weight=loss.get("speech_weight", 1.0),
                             speaker_weight=loss.get("speaker_weight", 1.0)), "multitask"
    model_cfg, mode = speaker_model_config(cfg)
    return _speaker_task(cfg, Wav2Vec2SpeakerModel(model_cfg, num_speakers=n_out), mode), "speaker"


def _normalize_schedule_cfg(sched_cfg: Dict) -> Dict:
    """The schedule config with the reference's nested override paths
    (``optim.schedule.scheduler[.lr_lambda].<key>``) folded onto its flat
    keys, the nested value winning (:596)."""
    nested = sched_cfg.get("scheduler")
    if not isinstance(nested, dict):
        return sched_cfg
    out = dict(sched_cfg)
    for src in (nested, nested.get("lr_lambda")):
        if isinstance(src, dict):
            out.update({k: v for k, v in src.items() if not isinstance(v, dict)})
    return out


def _schedule(sched_cfg: Dict, lr: float, max_steps: int):
    """The learning-rate schedule of ``optim.schedule`` (:620-668); the
    ``cyclic`` branch takes an absolute ``base_lr`` / ``max_lr``, or
    ``max_lr_factor`` x the base, and ``reduce_on_plateau`` holds the base
    rate times its controller's factor."""
    name = sched_cfg["name"]
    if name == "one_cycle":
        return schedules.one_cycle(max_lr=lr, total_steps=max_steps, pct_start=sched_cfg["pct_start"],
                                   div_factor=sched_cfg["div_factor"], final_div_factor=sched_cfg["final_div_factor"])
    if name == "tri_stage":
        return schedules.tri_stage(max_steps, sched_cfg["warmup_stage_ratio"], sched_cfg["constant_stage_ratio"],
                                   sched_cfg["decay_stage_ratio"], sched_cfg["initial_lr"], lr, sched_cfg["final_lr"])
    if name == "constant":
        return schedules.constant(lr)
    if name == "exp_decay":
        return schedules.exp_decay(max_steps, lr, sched_cfg["final_lr"])
    if name == "cyclic":
        base = sched_cfg.get("base_lr", lr)
        max_lr = sched_cfg.get("max_lr") or base * sched_cfg["max_lr_factor"]
        return schedules.cyclic(base, max_lr, sched_cfg["step_size_up"], sched_cfg.get("step_size_down"))
    if name == "multi_step":
        return schedules.multi_step_decay(lr, sched_cfg["milestones"], sched_cfg["gamma"])
    if name == "reduce_on_plateau":
        return schedules.PlateauSchedule(lr, schedules.ReduceLROnPlateauController(
            factor=sched_cfg.get("factor", 0.1), patience=sched_cfg.get("patience", 10)))
    raise ValueError(f"unknown schedule {name}")


def _mu_dtype(name) -> Optional[torch.dtype]:
    """``optim.algo.mu_dtype``: null, or a dtype name (``bfloat16``)."""
    if not name:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"optim.algo.mu_dtype must name a floating dtype, got {name!r}")
    return dtype


def build_optimizer(cfg: Dict):
    """The update transform of a merged config (:616): Adam (AdamW with
    ``weight_decay``, the first moment in ``mu_dtype``) or SGD with
    momentum (and weight decay added to the gradient) under the schedule
    of ``optim.schedule``, optional global-norm clipping, then the freeze
    schedules, composed in the order of the JAX ``build_optimizer``."""
    algo = cfg["optim"]["algo"]
    sched = _schedule(_normalize_schedule_cfg(cfg["optim"]["schedule"]), algo["lr"], cfg["trainer"]["max_steps"])
    if algo["name"] == "adam":
        tx = AdamTx(sched, b1=algo["b1"], b2=algo["b2"], weight_decay=algo.get("weight_decay") or 0.0,
                    mu_dtype=_mu_dtype(algo.get("mu_dtype")))
    elif algo["name"] == "sgd":
        tx = SgdTx(sched, momentum=algo.get("momentum"), weight_decay=algo.get("weight_decay") or 0.0)
    else:
        raise ValueError(f"unknown optimizer {algo['name']}")
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


# ------------------------------------------------------------------ data


def build_augmenter(pipeline_cfg: Dict, seed: int) -> Optional[Augmenter]:
    """The ``Augmenter`` of ``data.pipeline.augment`` (:97), None when it is
    not enabled or names no effect. The effects chain in the reference
    study's order, each on its own generator: time dropout (``seed`` + 2),
    frequency dropout (+5), uniform speed (+1), choice speed (+6),
    SpecAugment speeds (+7), reverb (+4), then RIRS noise or else uniform
    noise (+3). A dict-valued effect (``time_dropout``, ``freq_dropout``)
    is on when present, ``{}`` meaning its defaults; the others when
    truthy."""
    aug = pipeline_cfg.get("augment") or {}
    if not aug.get("enabled"):
        return None
    chain = []
    if aug.get("time_dropout") is not None:
        td = aug["time_dropout"]
        chain.append(TimeDropoutAugment(max_dropout_length_seconds=td.get("max_seconds", 0.25),
                                        min_drop_count=td.get("min_count", 0), max_drop_count=td.get("max_count", 5),
                                        seed=seed + 2))
    if aug.get("freq_dropout") is not None:
        fd = aug["freq_dropout"]
        chain.append(FrequencyDropoutAugment(min_drop_count=fd.get("min_count", 0),
                                             max_drop_count=fd.get("max_count", 5),
                                             band_scaling=fd.get("band_scaling", 1.0), seed=seed + 5))
    if aug.get("speed"):
        chain.append(UniformSpeedAugment(min_speed_factor=aug["speed"]["min"], max_speed_factor=aug["speed"]["max"],
                                         seed=seed + 1))
    if aug.get("speed_choices"):
        chain.append(ChoiceSpeedAugment(possible_speed_factors=aug["speed_choices"], seed=seed + 6))
    if aug.get("spec_augment_speeds"):
        chain.append(SpecAugmentTimeDomain(speeds=aug["spec_augment_speeds"], seed=seed + 7))
    if aug.get("reverb"):
        rv = aug["reverb"] if isinstance(aug["reverb"], dict) else {}
        chain.append(ReverbAugment(room_scale_min=rv.get("room_scale_min", 0),
                                   room_scale_max=rv.get("room_scale_max", 100), seed=seed + 4))
    if aug.get("rirs_shards"):
        chain.append(ChoiceRirsNoiseAugment(
            aug["rirs_shards"], snr_choices=aug.get("rirs_snr") or aug.get("noise_snr") or [5, 10, 15, 20],
            seed=seed + 3))
    elif aug.get("noise_snr"):
        chain.append(ChoiceRandomNoiseAugment(snr_choices=aug["noise_snr"], seed=seed + 3))
    if not chain:
        return None
    return Augmenter(chain, stack_augmentations=aug.get("stack", True),
                     yield_intermediate_augmentations=aug.get("yield_intermediate", False),
                     yield_unaugmented=aug.get("yield_unaugmented", False))


def _queue_size(cfg: Dict) -> int:
    """The batch processors' sample queue: ``data.shards.queue_size`` where
    set, else ``data.dataloader.queue_size`` (:188)."""
    return cfg["data"]["shards"].get("queue_size") or cfg["data"]["dataloader"]["queue_size"]


_LIBRISPEECH_SPLITS = (("train", "train_dir"), ("val_clean", "val_clean_dir"), ("val_other", "val_other_dir"),
                       ("test_clean", "test_clean_dir"), ("test_other", "test_other_dir"))


def _librispeech_module(cfg: Dict) -> LibriSpeechDataModule:
    """The prepared LibriSpeech module of ``cfg`` (:254-290): the splits
    whose directory exists, the token budget, the tokenizer group's
    vocabulary, speaker labels when asked for and always for the
    ``wav2vec2_multitask`` network."""
    m, dl = cfg["data"]["module"], cfg["data"]["dataloader"]
    dm = LibriSpeechDataModule(LibriSpeechConfig(
        split_dirs={split: pathlib.Path(m[key]) for split, key in _LIBRISPEECH_SPLITS
                    if m.get(key) and pathlib.Path(m[key]).exists()},
        shards_dir=pathlib.Path(m["shards_dir"]),
        train_max_num_samples=dl["train_max_num_samples"],
        max_batch_size=dl.get("max_batch_size"),
        max_queue_size=_queue_size(cfg),
        pad_to_multiple=dl["pad_to_multiple"],
        tokenizer_name=(cfg.get("tokenizer") or {}).get("name", "corpus_char"),
        with_speaker_labels=bool(m.get("with_speaker_labels")) or cfg["network"]["name"] == "wav2vec2_multitask",
        seed=cfg["seed"],
    ))
    dm.prepare_data()
    return dm


def build_data_module(cfg: Dict) -> Union[VoxCelebDataModule, LibriSpeechDataModule]:
    """The prepared data module of ``cfg`` (:198): VoxCeleb (shards, splits
    and validation pairs written on first use) or LibriSpeech."""
    m = cfg["data"]["module"]
    if m["name"] == "librispeech":
        return _librispeech_module(cfg)
    if m["name"] != "voxceleb":
        raise ValueError(f"unknown data module {m['name']}")
    p, s, dl = cfg["data"]["pipeline"], cfg["data"]["shards"], cfg["data"]["dataloader"]

    def opt_path(key):
        return pathlib.Path(m[key]) if m.get(key) else None

    dm = VoxCelebDataModule(VoxCelebConfig(
        data_dir=opt_path("data_dir"),
        shards_dir=pathlib.Path(m["shards_dir"]),
        test_trial_path=opt_path("test_trial_path"),
        voxceleb1_dev_dir=opt_path("voxceleb1_dev_dir"),
        voxceleb1_test_dir=opt_path("voxceleb1_test_dir"),
        voxceleb2_dev_dir=opt_path("voxceleb2_dev_dir"),
        voxceleb2_test_dir=opt_path("voxceleb2_test_dir"),
        use_voxceleb1_dev=m.get("use_voxceleb1_dev", True),
        use_voxceleb1_test=m.get("use_voxceleb1_test", True),
        use_voxceleb2_dev=m.get("use_voxceleb2_dev", True),
        use_voxceleb2_test=m.get("use_voxceleb2_test", False),
        all_voxceleb1_is_test_set=m.get("all_voxceleb1_is_test_set", False),
        has_train=m.get("has_train", True),
        has_val=m.get("has_val", True),
        has_test=m.get("has_test", True),
        train_val_split_mode=m["train_val_split_mode"],
        train_val_ratio=m["train_val_ratio"],
        num_val_speakers=m.get("num_val_speakers") or 0,
        eer_validation_pairs=m["eer_validation_pairs"],
        samples_per_shard=s["samples_per_shard"],
        sequential_same_speaker_samples=s["sequential_same_speaker_samples"],
        min_unique_speakers_per_shard=s["min_unique_speakers_per_shard"],
        use_gzip_compression=s["use_gzip_compression"],
        shuffle_shards=s["shuffle_shards"],
        queue_size=_queue_size(cfg),
        batch_size=dl.get("train_batch_size") or dl["batch_size"],
        chunk_length_sec=p["chunk_length_sec"],
        chunk_strategy=p["chunk_strategy"],
        normalize_input=p["normalize_input"],
        augmenter=build_augmenter(p, cfg["seed"]),
        limit_samples=m.get("limit_samples"),
        num_pipeline_workers=dl.get("num_pipeline_workers", 1),
        seed=cfg["seed"],
    ))
    dm.prepare_data()
    return dm


# ------------------------------------------------------- train, validate, test


def _validate_int8_config(cfg: Dict) -> None:
    """``network.int8_matmuls`` is true, false or auto, and not true in a
    training run (int8 matmuls have no gradient), as :796."""
    val = _canon_int8(cfg["network"].get("int8_matmuls", False))
    if val not in (True, False, "auto"):
        raise ValueError(f"network.int8_matmuls must be true/false/auto, got {val!r}")
    if val is True and cfg.get("fit_model", True):
        raise ValueError(
            "network.int8_matmuls is inference-only; training recipes must keep bf16/f32 matmuls "
            "(use fit_model=false for an int8 eval-only run, or predict for extraction)")


def _apply_fast_dev_run(cfg: Dict) -> None:
    """``trainer.fast_dev_run`` (:816): true -> 1, or n: n train, val and
    test batches, n steps and one validation, no sanity validation, no
    checkpoints and no resume."""
    fdr = cfg["trainer"].get("fast_dev_run")
    if not fdr:
        return
    n = 1 if fdr is True else int(fdr)
    t = cfg["trainer"]
    t["max_steps"] = t["val_check_interval"] = n
    t["limit_train_batches"] = t["limit_val_batches"] = t["limit_test_batches"] = n
    t["num_sanity_val_steps"] = 0
    t["resume"] = False
    print(f"fast_dev_run: {n} train/val/test batch(es), checkpointing disabled")


def check_deterministic(cfg: Dict) -> None:
    """Raise for a ``trainer.deterministic`` that is not a bool. Every
    recipe trains under it on the card too: the CTC recipes' loss runs the
    port's own kernels (``ops/ctc.py``), which use no atomics."""
    det = cfg["trainer"].get("deterministic", False)
    if not isinstance(det, bool):
        raise ValueError(f"trainer.deterministic must be a bool, got {det!r}")


def _check_ported(cfg: Dict) -> None:
    """Raise, before any data is read, for what this runtime does not
    take: a ``trainer.deterministic`` that is not a bool
    (``check_deterministic``)."""
    check_deterministic(cfg)


CUBLAS_WORKSPACE = ":4096:8"


def _cublas_workspace() -> None:
    """``CUBLAS_WORKSPACE_CONFIG`` for deterministic cuBLAS, set before the
    process's first CUDA work. PyTorch reads the variable at each call
    that checks it, but cuBLAS sizes its workspace when its handle is
    made, so a value set after that passes the check and buys nothing:
    with CUDA already in use and the variable unset, raise."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") in (CUBLAS_WORKSPACE, ":16:8"):
        return
    if torch.cuda.is_initialized():
        raise RuntimeError(
            f"trainer.deterministic=true needs CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} in the environment "
            "before the process's first CUDA work, and this process has used the card already: start it with "
            "the variable set (python -m w2v2_speaker_tpu_torch.run sets it itself when it runs first)")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE


@contextlib.contextmanager
def deterministic_mode(enabled: bool, device: torch.device):
    """``trainer.deterministic``: deterministic algorithms (never
    ``warn_only``), cuDNN's deterministic algorithms and no benchmark for
    the length of the block, the previous state restored after it; on the
    card, ``CUBLAS_WORKSPACE_CONFIG`` first (``_cublas_workspace``)."""
    if not enabled:
        yield
        return
    if device.type == "cuda":
        _cublas_workspace()
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
              cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    print("trainer.deterministic=true: deterministic algorithms, cuDNN deterministic, no benchmark")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        cudnn.deterministic, cudnn.benchmark = before[2], before[3]


def run_train_eval(cfg: Dict, device: DeviceLike = None) -> Optional[float]:
    """Train and test the speaker, paired, speech or multitask recipe of
    ``cfg`` (:840); returns the test EER (the validation EER without test
    trials), the test-clean WER (the validation WER without it) for speech,
    or None when ``eval_model`` is false or the test phase is skipped. Runs
    on the card unless ``device="cpu"``, and raises without a card, or with
    more ranks on the card than cards, before it reads anything.

    ``trainer.num_devices`` N > 1 (``all``: every card, 1 on the CPU) runs
    N data-parallel ranks (``parallel/mesh.py``): in the process group that
    exists (a caller's or torchrun's), else in N ranks spawned here (NCCL, a
    card a rank, on the card; gloo on the CPU), whose rank 0's objective
    this returns; the data are prepared (shards written on first use)
    before the ranks start. Rank 0 alone reads the data (every batch, the end of each
    epoch and of the data reach the others by broadcast), logs and writes
    checkpoints; the validation metrics every decision reads (early
    stopping, the plateau controller, best-k) are rank 0's; evaluation
    shards its rows over the ranks and gathers them. The global batch, its
    rows, microbatches, dropout masks, BatchNorm statistics and loss means
    are those of the JAX package's mesh at the same N."""
    requested = torch.device("cuda" if device is None else device)
    n = resolve_num_devices(cfg["trainer"].get("num_devices", "all"), requested)
    if not dist.is_initialized():  # a caller's group is taken as given (gloo ranks may share a card)
        check_cards(n, requested)
    _validate_int8_config(cfg)
    _check_ported(cfg)
    if needs_spawn(n):
        build_data_module(cfg)  # shards written here, before any rank waits in a timed collective
        return spawn(run_train_eval, (cfg, device), nprocs=n, device=requested.type,
                     threads=max(torch.get_num_threads() // n, 1))
    dev = resolve_device(device)
    seed = int(cfg["seed"])
    np.random.seed(seed)
    _apply_fast_dev_run(cfg)
    mesh = create_mesh(n, device=dev)
    with use_mesh(mesh), deterministic_mode(cfg["trainer"].get("deterministic", False), mesh.device):
        return broadcast_object(_train_eval(cfg, mesh.device, seed), mesh)


class RankZeroData:
    """A data module that rank 0 alone builds and runs, seen alike from
    every rank: each batch or sample an iterator yields on rank 0, and its
    end, is broadcast (``shared_iter``); so is each other call's result.
    The ranks draw in step, as ranks that run the same loop on the same
    data do. ``cfg`` is rank 0's on rank 0 and, elsewhere, a view of what
    the loop reads of it (``split_dirs``, whether there is an augmenter,
    ``debug_capture``)."""

    _ITERATORS = ("train_batches", "val_batches", "test_samples", "eval_batches", "_pipeline")
    _CALLS = ("summary", "val_evaluation_pairs", "test_evaluation_pairs")
    _VALUES = ("num_speakers", "tokenizer")

    def __init__(self, dm, mesh):
        self._dm, self._mesh = dm, mesh
        view = broadcast_object(None if dm is None else {
            "split_dirs": getattr(dm.cfg, "split_dirs", None),
            "augmenter": getattr(dm.cfg, "augmenter", None) is not None}, mesh)
        self.cfg = dm.cfg if mesh.is_main else SimpleNamespace(
            split_dirs=view["split_dirs"], augmenter=True if view["augmenter"] else None, debug_capture=None)

    def __getattr__(self, name):
        main, dm, mesh = self._mesh.is_main, self._dm, self._mesh
        if name in RankZeroData._ITERATORS:
            return lambda *a, **k: _SharedIterable(getattr(dm, name)(*a, **k) if main else None, mesh)
        if name in RankZeroData._CALLS:
            return lambda *a, **k: broadcast_object(getattr(dm, name)(*a, **k) if main else None, mesh)
        if name in RankZeroData._VALUES:
            return broadcast_object(getattr(dm, name) if main else None, mesh)
        raise AttributeError(name)


class _SharedIterable:
    """Rank 0's iterable seen from every rank, iterable again as the
    iterable it wraps is (an LR range test starts its epoch over)."""

    def __init__(self, items, mesh):
        self.items, self.mesh = items, mesh

    def __iter__(self):
        return shared_iter(self.items, self.mesh)


def _train_eval(cfg: Dict, dev: torch.device, seed: int) -> Optional[float]:
    if cfg.get("use_cometml"):
        try:
            import comet_ml  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "use_cometml=true but the comet_ml package is not available in this environment; "
                "install it or use the TensorBoard path (trainer.log_dir=...)") from e
    if dev.type == "cuda":
        set_float32_precision()

    mesh = current_mesh()
    main = mesh is None or mesh.is_main
    logger = MetricsLogger(log_dir=cfg["trainer"].get("log_dir") if main else None,
                           flush_every=cfg["trainer"].get("log_every", 100), console=main)
    print(f"experiment: {cfg.get('experiment_name')}")
    speech = cfg["data"]["module"]["name"] == "librispeech"
    if mesh is not None and mesh.distributed:
        print(f"data parallel: rank {mesh.rank} of {mesh.world} on {mesh.device} ({mesh.backend})")
        dm = RankZeroData(build_data_module(cfg) if main else None, mesh)
    else:
        dm = build_data_module(cfg)
    if not speech:
        print(dm.summary())
    if cfg["trainer"].get("dump_first_batch"):
        mon = (cfg.get("callbacks") or {}).get("input_monitor") or {}
        dm.cfg.debug_capture = PipelineDebugCapture(
            pathlib.Path(mon.get("out_dir") or pathlib.Path(cfg["trainer"]["checkpoint_dir"]).parent
                         / "first_batch" / "per_sample"),
            max_samples=int(4 if mon.get("max_samples") is None else mon["max_samples"]))  # 0: none
    multitask = cfg["network"]["name"] == "wav2vec2_multitask"
    with torch.device("meta"):
        task, kind = build_model_and_task(cfg, dm.num_speakers if multitask or not speech else 0,
                                          tokenizer=dm.tokenizer if speech else None)
    task.model.to_empty(device=dev)
    init_parameters(task.model, torch.Generator(device=dev).manual_seed(seed))
    if cfg.get("run_lr_range_test") or cfg.get("tune_model"):
        return _lr_range_test(cfg, dm, task, logger, dev)
    run = {"paired": _run_paired, "speaker": _run_speaker, "speech": _run_speech,
           "multitask": _run_multitask}[kind]
    return run(cfg, dm, task, logger, dev)


def _lr_range_test(cfg: Dict, dm, task, logger, device: torch.device) -> float:
    """``run_lr_range_test`` / ``tune_model`` (:950-970): the LR range test
    of ``runtime/lr_find.py`` over ``tune_iterations`` (100 by default)
    training batches from the initial weights, its ``data.json`` (and
    plot) in ``<checkpoint_dir>/../auto_lr_find``; returns the suggested
    rate instead of training. The example batch is drawn first where its
    draw moves state, as ``_example_batch`` says."""
    from .lr_find import lr_range_test

    _example_batch(cfg, dm)
    result = lr_range_test(task, dm.train_batches(), device, num_steps=int(cfg.get("tune_iterations") or 100),
                           output_dir=pathlib.Path(cfg["trainer"]["checkpoint_dir"]).parent / "auto_lr_find")
    print(f"lr suggestion: {result['suggestion']}")
    logger.close()
    return result["suggestion"]


def graft_pretrained(model, net: Dict) -> None:
    """The converted HF backbone of ``network.pretrained_checkpoint``
    grafted into ``model.wav2vec2`` (:983-1004). A model without that
    submodule (the paired model, and the networks off the wav2vec2
    backbone) keeps its initialisation, as in the JAX package (:996); a
    line says so. The file is read where the model has a backbone config
    to convert it with, as the JAX package reads it."""
    path = net.get("pretrained_checkpoint")
    if not path:
        return
    w2v2 = getattr(getattr(model, "cfg", None), "w2v2", None)
    ported = None if w2v2 is None else load_hf_checkpoint(path, w2v2)
    if hasattr(model, "wav2vec2"):
        graft_into(model.wav2vec2, ported, path)
    else:
        print(f"network.pretrained_checkpoint: {type(model).__name__} has no wav2vec2 submodule; "
              f"the checkpoint is not loaded, as in the JAX package")


def verify_model(task, example: Optional[Dict], device: torch.device) -> None:
    """``verify_model`` (:1007-1019): print ``model_summary``; for a task
    that embeds speakers (speaker, multitask) and an ``example`` batch of
    at least 2 rows, the cross-batch leakage probe through the model's
    ``compute_embedding`` on ``device`` (raises ``AssertionError`` on a
    leak)."""
    print(model_summary(task.model))
    if not isinstance(task, (SpeakerTask, MultitaskTask)) or example is None or example["features"].shape[0] < 2:
        return

    @torch.inference_mode()
    def embed(features, mask):
        return task.model.compute_embedding(
            torch.from_numpy(features).to(device),
            None if mask is None else torch.from_numpy(mask).to(device)).float().cpu().numpy()

    batch_gradient_verification(embed, np.asarray(example["features"]), example.get("mask"))
    print("batch gradient verification: no cross-batch leakage")


def _example_batch(cfg: Dict, dm, train_iter=None) -> Optional[Dict]:
    """The first training batch of ``train_iter()`` (``dm.train_batches()``
    without one), drawn before training as the JAX package draws it
    (:1473, :1722), where something reads it or its draw moves state that
    training reads: ``verify_model``, the debug capture, an augmenter; else
    None, and no draw."""
    if not (cfg.get("verify_model") or dm.cfg.debug_capture is not None
            or getattr(dm.cfg, "augmenter", None) is not None):  # LibriSpeech has no augmenter
        return None
    return next(iter(train_iter() if train_iter is not None else dm.train_batches()))


def _init_state(cfg: Dict, task, example: Optional[Dict] = None, device: Optional[torch.device] = None) -> TrainState:
    """The train state over ``task.model`` (:983): ``graft_pretrained``,
    then ``load_network_from_checkpoint`` grafted into the whole model,
    ``verify_model`` on ``example`` where asked for, the optimizer of
    ``build_optimizer``, and the step generator seeded with ``seed + 1``."""
    model = task.model
    graft_pretrained(model, cfg["network"])
    if cfg.get("load_network_from_checkpoint"):
        load_params(cfg["load_network_from_checkpoint"], model)
    if cfg.get("verify_model"):
        verify_model(task, example, device)
    return TrainState.create(model, build_optimizer(cfg), seed=int(cfg["seed"]) + 1)


class EarlyStopping:
    """Stop when the monitored metric stops improving or diverges (:1047):
    PyTorch Lightning's ``EarlyStopping`` on ``val_eer`` with ``min_delta``,
    ``patience``, ``mode``, ``check_finite`` and ``divergence_threshold``.
    ``update`` returns the reason to stop, or None."""

    def __init__(self, monitor="val_eer", min_delta=0.0, patience=4, mode="min", check_finite=True,
                 divergence_threshold=None):
        self.monitor = monitor
        self.min_delta = abs(float(min_delta))
        self.patience = int(patience)
        self.sign = -1.0 if mode == "min" else 1.0
        self.check_finite = bool(check_finite)
        self.divergence_threshold = divergence_threshold
        self.best = None
        self.wait = 0

    def update(self, val_metrics: Dict) -> Optional[str]:
        if self.monitor not in val_metrics:
            return None
        value = float(val_metrics[self.monitor])
        if self.check_finite and not np.isfinite(value):
            return f"{self.monitor} is not finite ({value})"
        if self.divergence_threshold is not None and (
                self.sign * value < self.sign * float(self.divergence_threshold)):
            return f"{self.monitor}={value:.4f} diverged past {self.divergence_threshold}"
        if self.best is None or self.sign * value > self.sign * self.best + self.min_delta:
            self.best, self.wait = value, 0
            return None
        self.wait += 1
        if self.wait >= self.patience:  # after `patience` validations without improvement
            return f"{self.monitor} did not improve for {self.wait} validations (best {self.best:.4f})"
        return None


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The arrays of a numpy batch as tensors on ``device``; the host-only
    lists (``keys``, ``transcriptions``) stay behind."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def _to_host(metrics: Dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.tensor(v)
            for k, v in metrics.items()}


def _train_loop(cfg, task, state: TrainState, logger, train_iter_fn, validate_fn, device,
                on_step=None, kind: str = "speaker"):
    """The training loop of :1094 on one card. Returns ``(state, ckpt)``,
    ``ckpt`` None when nothing was checkpointed (no fit, fast_dev_run).
    ``kind`` "speech" checkpoints on ``val_wer``, the others on
    ``val_eer``. "speech" and "multitask" refuse ``steps_per_dispatch`` > 1
    and train every token-budget batch as it comes, its rows padded to a
    multiple of the accumulation count; the other kinds drop a batch whose
    rows differ from the first one's."""
    if not cfg.get("fit_model", True):
        return state, None  # evaluation runs on the weights as loaded
    trainer = cfg["trainer"]
    max_steps = trainer["max_steps"]
    val_every = trainer.get("val_check_interval") or max_steps
    limit_train = trainer.get("limit_train_batches")
    acc = trainer.get("accumulate_grad_batches", 1)
    min_steps = int(trainer.get("min_steps") or 0)
    max_epochs = trainer.get("max_epochs")
    max_epochs = float("inf") if max_epochs is None else int(max_epochs)
    min_epochs = int(trainer.get("min_epochs") or 0)
    fast_dev = bool(trainer.get("fast_dev_run"))

    speech = kind in ("speech", "multitask")  # token-budget batches
    mesh = current_mesh()
    main = mesh is None or mesh.is_main
    rows_multiple = acc * (1 if mesh is None else mesh.data)  # the rows a batch splits into
    ckpt = CheckpointManager(trainer["checkpoint_dir"], monitor="val_wer" if kind == "speech" else "val_eer",
                             top_k=int(trainer.get("save_top_k", 1)), mesh=mesh)
    resumed_epoch = 0
    if trainer.get("resume"):
        try:
            state = ckpt.restore(state, name="last")
            resumed_epoch = ckpt.last_epoch() or 0
            print(f"resumed from step {int(state.step)} (epoch {resumed_epoch})")
        except FileNotFoundError:
            print("resume requested but no 'last' checkpoint; starting fresh")

    # reduce_on_plateau: the schedule holds base_lr x the controller's
    # factor, and the controller's state is checkpointed with the optimizer
    plateau = find_schedule(state.tx)
    plateau = plateau if isinstance(plateau, schedules.PlateauSchedule) else None

    early_stop = None
    es_cfg = (cfg.get("callbacks") or {}).get("early_stopping")
    if es_cfg:
        early_stop = EarlyStopping(
            monitor=es_cfg.get("monitor", "val_eer"), min_delta=es_cfg.get("min_delta", 0.0),
            patience=es_cfg.get("patience", 4), mode=es_cfg.get("mode", "min"),
            check_finite=es_cfg.get("check_finite", True),
            divergence_threshold=es_cfg.get("divergence_threshold"))

    step = int(state.step)
    epoch = resumed_epoch
    expected_rows = None
    dropped_ragged = 0
    stop_reason = None
    epoch_batches = 0
    validated_at = -1

    # steps_per_dispatch K: K batches stacked into one dispatch of K steps,
    # whose metrics come to the host once; a dispatch never straddles a
    # validation, max_steps or limit_train_batches boundary
    spd = int(trainer.get("steps_per_dispatch") or 1)
    if spd > 1 and speech:
        raise ValueError("steps_per_dispatch needs fixed-shape batches; the speech/multitask token-budget "
                         "batcher varies shapes by design")
    step_fns = {}

    def get_step_fn(k: int):
        if k not in step_fns:
            step_fns[k] = make_train_step(task, accumulate_steps=acc, return_embeddings=on_step is not None,
                                          steps_per_dispatch=k, mesh=mesh)
        return step_fns[k]

    # profiler=jax_trace: a torch.profiler window over steps [prof_start,
    # prof_start + prof_len) (counted from 0), its own trace file
    prof = cfg.get("profiler") or {}
    prof_active = prof.get("name") == "jax_trace"
    prof_start, prof_len = int(prof.get("start_step", 10)), int(prof.get("num_steps", 5))
    profiler = None

    def chunk_take() -> int:
        take = min(spd, max_steps - step, val_every - step % val_every)
        if limit_train:
            take = min(take, limit_train - epoch_batches)
        if prof_active:  # a dispatch never straddles the window
            if step < prof_start:
                take = min(take, prof_start - step)
            elif step < prof_start + prof_len:
                take = min(take, prof_start + prof_len - step)
        return max(take, 1)

    def start_profiler():
        nonlocal profiler
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    def stop_profiler():
        nonlocal profiler, prof_active
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        profiler.stop()
        out = pathlib.Path(prof["trace_dir"]) / ("trace.json" if main else f"trace_rank{mesh.rank}.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out))
        print(f"profiler: steps {prof_start + 1}-{step} traced to {out}")
        profiler, prof_active = None, False

    buf: List[Dict] = []

    def dump_failed_step_batches():
        """Every batch of the failed dispatch, as the data module gave it
        (keys included), under ``debug_batch/train_step`` (``/chunk<i>``
        for more than one) beside the checkpoint directory (:1225-1245)."""
        dump_dir = pathlib.Path(trainer["checkpoint_dir"]).parent / "debug_batch" / "train_step"
        for i, raw in enumerate(buf if main else ()):
            dump_first_batch(raw, dump_dir if len(buf) == 1 else dump_dir / f"chunk{i}")
        print(f"training step at step={step} raised; offending batch(es) dumped to {dump_dir}")

    def run_chunk():
        nonlocal state, step, epoch_batches, buf
        try:
            if prof_active and step == prof_start:
                start_profiler()
            label = f"train_step_{step + 1}" if len(buf) == 1 else f"train_steps_{step + 1}-{step + len(buf)}"
            with (torch.profiler.record_function(label) if profiler is not None else contextlib.nullcontext()):
                if len(buf) == 1:
                    state, m = get_step_fn(1)(state, _to_device(select_rows(buf[0], mesh, acc), device))
                    per_step = [(buf[0], _to_host(m))]
                else:
                    stacked = {key: np.stack([b[key] for b in buf]) for key in buf[0] if key != "keys"}
                    stacked = select_rows(stacked, mesh, acc, stacked=True)
                    state, sm = get_step_fn(len(buf))(state, _to_device(stacked, device))
                    sm = _to_host(sm)  # one copy per metric for the whole dispatch
                    per_step = [(buf[i], {k: v[i] for k, v in sm.items()}) for i in range(len(buf))]
        except Exception:
            dump_failed_step_batches()
            if profiler is not None:
                profiler.stop()  # no session left open behind the error
            raise
        buf = []
        for batch, m in per_step:
            step += 1
            emb = m.pop("_embedding", None)
            if on_step is not None:
                on_step(batch, emb)
            logger.log_step(step, {k: float(v) for k, v in m.items()})
            epoch_batches += 1
        if profiler is not None and step in (prof_start + prof_len, max_steps):
            stop_profiler()  # the window's end, or training's: before any validation

    def run_validation():
        nonlocal stop_reason, validated_at
        validated_at = step
        t0 = time.perf_counter()
        val_metrics = broadcast_object(validate_fn(state), mesh)  # every decision below is rank 0's
        logger.log_eval(step, {**val_metrics, "val_seconds": time.perf_counter() - t0})
        if plateau is not None:  # before the save, so that "last" resumes with this validation's factor
            before = plateau.controller.factor_value
            factor = plateau.controller.update(float(val_metrics.get("val_eer", val_metrics.get("val_wer", 1.0))))
            if factor != before:
                print(f"plateau: effective lr -> {plateau.base_lr * factor:.6g} (factor {factor:g})")
        if not fast_dev:
            ckpt.save_step(state, val_metrics, epoch=epoch)
        if early_stop is not None:
            stop_reason = early_stop.update(val_metrics)
            if stop_reason is not None and (step < min_steps or epoch < min_epochs):
                floor = (f"min_steps={min_steps}" if step < min_steps
                         else f"min_epochs={min_epochs} (at epoch {epoch})")
                print(f"early-stop condition at step {step} suppressed: {floor} not reached ({stop_reason})")
                stop_reason = None
            elif stop_reason is not None:
                print(f"early stopping at step {step}: {stop_reason}")

    # trainer.num_sanity_val_steps: validation batches before any training,
    # logged and never checkpointed or fed to early stopping; none under
    # fast_dev_run or a profiler window (:1327-1331)
    sanity = 0 if fast_dev or prof_active else int(trainer.get("num_sanity_val_steps") or 0)
    if sanity and step < max_steps:
        print(f"sanity validation: {sanity} batch(es)")
        t0 = time.perf_counter()
        sanity_metrics = validate_fn(state, max_batches=sanity)
        logger.log_eval(step, {**{f"sanity_{k}": v for k, v in sanity_metrics.items()},
                               "sanity_seconds": time.perf_counter() - t0})

    start_step = step
    first_batch_dumped = False
    while step < max_steps and epoch < max_epochs and stop_reason is None:
        epoch_batches = 0
        buf = []
        for batch in train_iter_fn(epoch):
            if not first_batch_dumped and trainer.get("dump_first_batch"):
                if main:
                    dump_first_batch(batch, pathlib.Path(trainer["checkpoint_dir"]).parent / "first_batch")
                first_batch_dumped = True
            rows = batch["labels"].shape[0]
            if speech:
                if rows % rows_multiple:  # padding rows have empty labels: left out of the CTC mean
                    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
                    batch = {**batch, **pad_batch_rows(arrays, -(-rows // rows_multiple) * rows_multiple)}
            else:
                if expected_rows is None:
                    expected_rows = rows
                    if rows % rows_multiple:
                        raise ValueError(f"batch size {rows} not divisible by accumulate_grad_batches={acc}"
                                         + (f" x {mesh.data} data ranks" if rows_multiple != acc else ""))
                if rows != expected_rows:
                    dropped_ragged += 1  # never silently: a mis-sized stream would train on a fraction
                    print(f"dropped ragged train batch #{dropped_ragged}: leading dim {rows} != {expected_rows}")
                    continue
            buf.append(batch)
            if len(buf) < chunk_take():
                continue
            run_chunk()
            if step % val_every == 0 or step >= max_steps:
                run_validation()
                if stop_reason is not None:
                    break
            if step >= max_steps or (limit_train and epoch_batches >= limit_train):
                break
        if buf and stop_reason is None and step < max_steps:
            run_chunk()  # the iterator ended inside a dispatch: train what it gave
            if step % val_every == 0 or step >= max_steps:
                run_validation()
        if stop_reason is not None:
            break
        if limit_train and step < max_steps and validated_at != step:
            run_validation()  # limit_train_batches ends an epoch: validate there
            if stop_reason is not None:
                break
        if epoch_batches == 0:
            raise RuntimeError("train loader yielded no usable batches")
        epoch += 1
    if (epoch >= max_epochs and step < max_steps and stop_reason is None and step > start_step
            and validated_at != step and not fast_dev):
        run_validation()  # the epoch cap ended training between validations
    if profiler is not None:
        stop_profiler()  # training ended inside the window
    if dropped_ragged:
        print(f"total ragged train batches dropped: {dropped_ragged}")
    return state, (None if fast_dev else ckpt)


def _limit_test_batches(cfg) -> Optional[int]:
    """``trainer.limit_test_batches``: None for the whole test split, 0 to
    skip the test phase, N for at most N batches (:1444)."""
    v = cfg["trainer"].get("limit_test_batches")
    return None if v is None else int(v)


def _restore_best(state: TrainState, ckpt: Optional[CheckpointManager], average_top_k: int = 1):
    """The best checkpoint (or the average of the best ``average_top_k``)
    after a fit; the state as it is without a fit or a checkpoint (:1452)."""
    if ckpt is None:
        return state
    try:
        if average_top_k > 1:
            return ckpt.average_best(state, average_top_k)
        return ckpt.restore(state, name="best")
    except FileNotFoundError:
        return state


@torch.inference_mode()
def _embed_batch(model, batch: Dict, device: torch.device) -> np.ndarray:
    """[B, D] float32 embeddings of a numpy batch (``features``, optional
    ``mask``), its rows sharded over the run's data ranks."""
    def embed(b):
        mask = b.get("mask")
        return model.compute_embedding(torch.from_numpy(b["features"]).to(device),
                                       None if mask is None else torch.from_numpy(mask).to(device)).float()

    return shard_map_rows(embed, {k: batch[k] for k in ("features", "mask") if batch.get(k) is not None},
                          current_mesh()).cpu().numpy()


def _run_speaker(cfg, dm: VoxCelebDataModule, task: SpeakerTask, logger, device) -> Optional[float]:
    """Fit, validate, restore the best checkpoint and score the test trials
    on full utterances (:1469). The triplet modes train on
    ``TripletBatchProcessor`` batches, seeded ``seed + epoch * 9973``
    (:1586-1601); ``network.use_transformers_as_ensembles`` scores the test
    trials on ``num_ensembles`` per-layer embeddings (:1636-1660)."""
    from .predict import extract_embeddings

    dl = cfg["data"]["dataloader"]
    evaluator = build_evaluator(cfg)
    state = _init_state(cfg, task, _example_batch(cfg, dm), device)
    model = task.model
    val_pairs = dm.val_evaluation_pairs()
    limit_val = cfg["trainer"].get("limit_val_batches")
    tracker = _progress_tracker(cfg, dm)

    # a rolling buffer of training embeddings for the evaluator's centering,
    # filled from the train step's own forward
    max_tr = int(evaluator.max_num_training_samples or 0)
    emb_buffer: Optional[Deque] = deque(maxlen=max_tr) if max_tr else None

    def on_step(batch, emb):
        if emb is None:
            return
        e, labels = emb.numpy(), np.asarray(batch["labels"]).reshape(-1)
        for j in range(min(len(e), len(labels))):
            emb_buffer.append((e[j], int(labels[j])))

    def collect_train_embeddings(max_samples):
        embs, labels, rows = [], [], None
        for batch in dm.train_batches():
            rows = rows or batch["features"].shape[0]
            if batch["features"].shape[0] != rows:
                continue
            embs.extend(_embed_batch(model, batch, device))
            labels.extend(np.asarray(batch["labels"]).tolist())
            if len(embs) >= max_samples:
                break
        return embs[:max_samples], labels[:max_samples]

    def validate(state, max_batches=None):
        track = {}  # the probe set's snapshot at real validations, not the sanity one
        if tracker is not None and max_batches is None:
            track = tracker.snapshot(int(state.step), lambda f, m: _embed_batch(
                model, {"features": f, "mask": m}, device))
        if not val_pairs:
            return {**track, "val_eer": 1.0}
        lim = max_batches if max_batches is not None else limit_val
        samples: List[EmbeddingSample] = []
        for i, batch in enumerate(dm.val_batches()):
            if lim and i >= lim:
                break
            e = _embed_batch(model, batch, device)
            samples.extend(EmbeddingSample(k, e[j]) for j, k in enumerate(batch["keys"]))
        seen = {s.sample_id for s in samples}
        usable = [p for p in val_pairs if p.sample1_id in seen and p.sample2_id in seen]
        if not usable:
            return {**track, "val_eer": 1.0}
        evaluator.reset_parameters()
        if max_tr:
            if emb_buffer:
                embs, labels = zip(*emb_buffer)
                evaluator.fit_parameters(list(embs), list(labels))
            else:
                evaluator.fit_parameters(*collect_train_embeddings(max_tr))
        res = evaluator.evaluate(usable, samples)
        return {**track, "val_eer": res["eer"], "val_mdc": res["mdc"]}

    def make_batch_processor(epoch):
        """Triplet modes need two samples of every speaker in a batch, so
        that each anchor has an in-batch positive; the others draw
        uniformly (the data module's default)."""
        if task.mode not in ("triplet", "triplet_ce"):
            return None
        return TripletBatchProcessor(max_batch_size=dl["batch_size"], max_queue_size=_queue_size(cfg),
                                     collate_fn=collate_speaker_batch, seed=cfg["seed"] + epoch * 9973)

    def train_iter(epoch=0):
        return dm.train_batches(batch_processor=make_batch_processor(epoch),
                                prefetch_depth=dl.get("prefetch_depth", 4), epoch=epoch)

    state, ckpt = _train_loop(cfg, task, state, logger, train_iter, validate, device,
                              on_step=on_step if max_tr else None)

    state = _restore_best(state, ckpt, int(cfg["trainer"].get("average_top_k", 1)))
    if not cfg.get("eval_model", True):
        logger.close()
        return None
    ltb = _limit_test_batches(cfg)
    if ltb == 0:
        print("limit_test_batches=0: skipping the test phase")
        logger.close()
        return None
    test_pairs = dm.test_evaluation_pairs()
    if not test_pairs:
        final = validate(state)
        logger.close()
        return float(final["val_eer"])
    t0 = time.perf_counter()
    test_samples = list(dm.test_samples())
    if ltb:
        test_samples = test_samples[: ltb * dl.get("test_batch_size", 8)]
    net = cfg["network"]
    samples = extract_embeddings(model, test_samples, pad_to_multiple=dl.get("test_pad_to_multiple", 16000),
                                 batch_size=dl.get("test_batch_size", 8), device=device, mesh=current_mesh(),
                                 num_ensembles=(int(net.get("num_ensembles", 12))
                                                if net.get("use_transformers_as_ensembles") else None))
    if ltb:  # a prefix of the test split: score the trials whose both sides it holds
        seen = {s.sample_id for s in samples}
        test_pairs = [p for p in test_pairs if p.sample1_id in seen and p.sample2_id in seen]
        if not test_pairs:
            print("limit_test_batches: no scoreable test trials; skipping")
            logger.close()
            return None
    evaluator.reset_parameters()
    if max_tr:  # centre with embeddings of the restored weights
        evaluator.fit_parameters(*collect_train_embeddings(max_tr))
    res = evaluator.evaluate(test_pairs, samples)
    logger.log_eval(int(state.step), {**{f"test_{k}": v for k, v in res.items()},
                                      "test_seconds": time.perf_counter() - t0}, split="test")
    logger.close()
    return float(res["eer"])


def _progress_tracker(cfg: Dict, dm: VoxCelebDataModule):
    """The ``ProgressTracker`` of ``callbacks.progress_tracker`` (:1480-1500)
    with its probe set picked from ``dm.train_batches()``, its snapshots
    under ``<checkpoint_dir>/../progress``; None without the callback, in
    an eval-only run, or when no tracked speaker's sample turns up."""
    pt_cfg = (cfg.get("callbacks") or {}).get("progress_tracker")
    if pt_cfg and not cfg.get("fit_model", True):
        print("progress tracker: fit_model=false, skipping")
        return None
    if not pt_cfg:
        return None
    from .progress import ProgressTracker

    mesh = current_mesh()
    tracker = ProgressTracker(  # another rank's snapshots (the same as rank 0's) go to a scratch directory
        out_dir=(pathlib.Path(str(cfg["trainer"]["checkpoint_dir"])).parent / "progress"
                 if mesh is None or mesh.is_main else tempfile.mkdtemp(prefix="w2v2_progress_")),
        num_speakers=int(pt_cfg.get("num_tracked_speakers", 5)), per_speaker=int(pt_cfg.get("per_speaker", 2)),
        heatmap=bool(pt_cfg.get("heatmap", True)), max_scan_batches=int(pt_cfg.get("max_scan_batches", 100)))
    if not tracker.select_samples(dm.train_batches()):
        print("progress tracker: no tracked-speaker samples; disabled")
        return None
    return tracker


def _warn_unsupported_progress_tracker(cfg, family: str) -> None:
    """The progress tracker probes the speaker recipe's embeddings: another
    family warns that it ignores a configured one (:1694)."""
    if (cfg.get("callbacks") or {}).get("progress_tracker"):
        print(f"progress tracker: unsupported for the {family} task family; callback ignored")


def _run_paired(cfg, dm: VoxCelebDataModule, task: PairedSpeakerTask, logger, device) -> Optional[float]:
    """Fit on generated pair batches, validate by scoring the validation
    pairs through the network, restore the best checkpoint and score the
    test trials on full-utterance pairs (:1704). The example pair batch
    of :1722 is drawn as ``_example_batch`` says."""
    _warn_unsupported_progress_tracker(cfg, "paired")
    dl = cfg["data"]["dataloader"]
    ratio = cfg.get("pos_neg_training_batch_ratio", 0.5)
    k = cfg["data"]["shards"]["sequential_same_speaker_samples"]

    def train_iter(epoch=0):
        proc = PairedBatchProcessor(
            batch_size=dl["batch_size"], max_queue_size=_queue_size(cfg), mode="generate",
            sequential_same_speaker_samples=k, collate_fn=collate_paired_batch,
            pos_neg_training_batch_ratio=ratio, seed=cfg["seed"] + epoch * 9973,
        )
        return dm.train_batches(proc, prefetch_depth=dl.get("prefetch_depth", 4), epoch=epoch)

    state = _init_state(cfg, task, _example_batch(cfg, dm, train_iter), device)

    def score_pairs(pairs, split, max_batches=None):
        """EER / minDCF of ``pairs`` from the sigmoid scores of full
        utterances (val: the val pipeline's samples), batches in trial
        order, each side padded to ``test_pad_to_multiple``."""
        proc = PairedBatchProcessor(
            batch_size=dl["batch_size"], max_queue_size=max(_queue_size(cfg), len(pairs) + 1),
            mode="reproduce", sequential_same_speaker_samples=1,
            collate_fn=lambda s: collate_paired_batch(s, pad_to_multiple=dl.get("test_pad_to_multiple", 16000)),
            pairs=pairs,
        )
        samples = dm._pipeline("val", train=False) if split == "val" else dm.test_samples()
        gts, scores = [], []
        for i, batch in enumerate(proc(samples)):
            if max_batches is not None and i >= max_batches:
                break
            scores.extend(shard_map_rows(lambda b: task.score_fn(_to_device(b, device)), batch,
                                         current_mesh()).cpu().tolist())
            gts.extend(batch["labels"].tolist())
        return paired_scores_to_metrics(gts, scores)

    val_pairs = dm.val_evaluation_pairs()
    limit_val = cfg["trainer"].get("limit_val_batches")

    def validate(state, max_batches=None):
        if not val_pairs:
            return {"val_eer": 1.0}
        m = score_pairs(val_pairs, "val", max_batches if max_batches is not None else limit_val)
        return {"val_eer": m["eer"], "val_mdc": m["mdc"]}

    state, ckpt = _train_loop(cfg, task, state, logger, train_iter, validate, device)
    state = _restore_best(state, ckpt, int(cfg["trainer"].get("average_top_k", 1)))
    if not cfg.get("eval_model", True):
        logger.close()
        return None
    ltb = _limit_test_batches(cfg)
    if ltb == 0:
        print("limit_test_batches=0: skipping the test phase")
        logger.close()
        return None
    test_pairs = dm.test_evaluation_pairs()
    if not test_pairs:
        final = validate(state)
        logger.close()
        return float(final["val_eer"])
    t0 = time.perf_counter()
    res = score_pairs(test_pairs, "test", max_batches=ltb)
    logger.log_eval(int(state.step), {**{f"test_{k}": v for k, v in res.items()},
                                      "test_seconds": time.perf_counter() - t0}, split="test")
    logger.close()
    return float(res["eer"])


def _make_transcription_tracker(raw_batch: Dict, task: SpeechTask, logger):
    """The first utterance of ``raw_batch``, tracked (:1804): its ground
    truth logged once, the model's transcription of it at each call."""
    one = {"features": raw_batch["features"][:1], "mask": raw_batch["mask"][:1]}
    logger.log_text(0, "train/tracked_ground_truth", raw_batch["transcriptions"][0])

    def track(state: TrainState) -> None:
        logger.log_text(int(state.step), "train/tracked_transcription", task.transcribe(one)[0])

    return track


def _make_wer_fn(dm: LibriSpeechDataModule, task: SpeechTask, eval_bs: int):
    """``wer(split, limit)``: the WER of ``split``'s first ``limit`` eval
    batches of ``eval_bs`` (all without a limit), None for an empty split
    (:1831)."""
    def logits_fn(features, mask=None):  # rows sharded over the data ranks (padding rows all valid)
        batch = {"features": np.asarray(features), **({} if mask is None else {"mask": np.asarray(mask)})}
        return shard_map_rows(lambda b: task.host_logits_fn(b["features"], b.get("mask")), batch, current_mesh(),
                              mask_fill=True)

    def wer(split: str, limit: Optional[int] = None) -> Optional[float]:
        batches = []
        for i, b in enumerate(dm.eval_batches(split, batch_size=eval_bs)):
            if limit and i >= limit:
                break
            batches.append(b)
        return task.evaluate_wer(batches, logits_fn)["wer"] if batches else None

    return wer


def _run_speech(cfg, dm: LibriSpeechDataModule, task: SpeechTask, logger, device) -> Optional[float]:
    """Fit on token-budget batches, validate the WER of the clean and other
    validation splits, restore the best checkpoint by ``val_wer`` and
    return the test-clean WER (:1874)."""
    _warn_unsupported_progress_tracker(cfg, "speech")
    raw_example = next(iter(dm.train_batches()))
    state = _init_state(cfg, task, raw_example, device)
    limit_val = cfg["trainer"].get("limit_val_batches")
    track_transcription = _make_transcription_tracker(raw_example, task, logger)
    wer = _make_wer_fn(dm, task, int(cfg["data"]["dataloader"].get("eval_batch_size", 8)))

    def validate(state, max_batches=None):
        track_transcription(state)
        lim = max_batches if max_batches is not None else limit_val
        metrics = {}
        for split in ("val_clean", "val_other"):
            if split in dm.cfg.split_dirs:
                value = wer(split, limit=lim)
                if value is not None:
                    metrics[f"val_wer_{split.split('_')[1]}"] = value
        metrics["val_wer"] = metrics.get("val_wer_clean", next(iter(metrics.values()), 1.0))
        return metrics

    def train_iter(epoch=0):
        return dm.train_batches(prefetch_depth=cfg["data"]["dataloader"].get("prefetch_depth", 4), epoch=epoch)

    state, ckpt = _train_loop(cfg, task, state, logger, train_iter, validate, device, kind="speech")
    state = _restore_best(state, ckpt, int(cfg["trainer"].get("average_top_k", 1)))
    if not cfg.get("eval_model", True):
        logger.close()
        return None
    ltb = _limit_test_batches(cfg)
    if ltb == 0:
        print("limit_test_batches=0: skipping the test phase")
        logger.close()
        return None
    t0 = time.perf_counter()
    results = {}
    for split in ("test_clean", "test_other"):
        if split in dm.cfg.split_dirs:
            value = wer(split, limit=ltb)
            if value is not None:
                results[split] = value
    if results:
        logger.log_eval(int(state.step), {**{f"{k}_wer": v for k, v in results.items()},
                                          "test_seconds": time.perf_counter() - t0}, split="test")
    objective = results["test_clean"] if "test_clean" in results else validate(state)["val_wer"]
    logger.close()
    return float(objective)


def _run_multitask(cfg, dm: LibriSpeechDataModule, task: MultitaskTask, logger, device) -> Optional[float]:
    """Fit on token-budget batches with speaker labels, validate the WER of
    both validation splits and the cosine EER of ``num_val_pairs`` speaker
    trials over the first, restore the best checkpoint by ``val_eer``, then
    log both test WERs and the trials' EER over the first test split;
    returns the test EER (:1949)."""
    _warn_unsupported_progress_tracker(cfg, "multitask")
    raw_example = next(iter(dm.train_batches()))
    state = _init_state(cfg, task, raw_example, device)
    limit_val = cfg["trainer"].get("limit_val_batches")
    evaluator = build_evaluator(cfg)
    eval_bs = int(cfg["data"]["dataloader"].get("eval_batch_size", 8))
    track_transcription = _make_transcription_tracker(raw_example, task, logger)
    val_splits = [s for s in ("val_clean", "val_other") if s in dm.cfg.split_dirs]
    num_pairs = int(cfg["data"]["module"].get("num_val_pairs", 200))
    val_pairs = dm.val_evaluation_pairs(val_splits[0], num_pairs) if val_splits else []
    wer = _make_wer_fn(dm, task, eval_bs)

    def embeddings(split, limit=None) -> List[EmbeddingSample]:
        samples: List[EmbeddingSample] = []
        for i, batch in enumerate(dm.eval_batches(split, batch_size=eval_bs)):
            if limit and i >= limit:
                break
            e = _embed_batch(task.model, batch, device)
            samples.extend(EmbeddingSample(k, e[j]) for j, k in enumerate(batch["keys"]))
        return samples

    def eer(split, pairs, limit=None) -> Optional[Dict]:
        if not pairs:
            return None
        samples = embeddings(split, limit=limit)
        seen = {s.sample_id for s in samples}
        usable = [p for p in pairs if p.sample1_id in seen and p.sample2_id in seen]
        if not usable:
            return None
        evaluator.reset_parameters()
        if evaluator.max_num_training_samples:  # centring statistics from training embeddings
            max_tr = int(evaluator.max_num_training_samples)
            tr_embs, tr_labels = [], []
            for batch in dm.train_batches():
                e = _embed_batch(task.model, batch, device)
                tr_embs.extend(e)
                tr_labels.extend(np.asarray(batch["speaker_labels"]).tolist()[: len(e)])
                if len(tr_embs) >= max_tr:
                    break
            evaluator.fit_parameters(tr_embs[:max_tr], tr_labels[:max_tr])
        return evaluator.evaluate(usable, samples)

    def validate(state, max_batches=None):
        track_transcription(state)
        lim = max_batches if max_batches is not None else limit_val
        metrics = {}
        for split in val_splits:
            value = wer(split, limit=lim)
            if value is not None:
                metrics[f"val_wer_{split.split('_')[1]}"] = value
        metrics["val_wer"] = metrics.get("val_wer_clean", 1.0)
        res = eer(val_splits[0], val_pairs, limit=max_batches) if val_splits else None
        metrics.update({"val_eer": res["eer"], "val_mdc": res["mdc"]} if res is not None else {"val_eer": 1.0})
        return metrics

    def train_iter(epoch=0):
        return dm.train_batches(prefetch_depth=cfg["data"]["dataloader"].get("prefetch_depth", 4), epoch=epoch)

    state, ckpt = _train_loop(cfg, task, state, logger, train_iter, validate, device, kind="multitask")
    state = _restore_best(state, ckpt, int(cfg["trainer"].get("average_top_k", 1)))
    if not cfg.get("eval_model", True):
        logger.close()
        return None
    ltb = _limit_test_batches(cfg)
    if ltb == 0:
        print("limit_test_batches=0: skipping the test phase")
        logger.close()
        return None
    t0 = time.perf_counter()
    results = {}
    test_splits = [s for s in ("test_clean", "test_other") if s in dm.cfg.split_dirs]
    for split in test_splits:
        value = wer(split, limit=ltb)
        if value is not None:
            results[f"{split}_wer"] = value
    test_eer = None
    if test_splits:
        res = eer(test_splits[0], dm.val_evaluation_pairs(test_splits[0], num_pairs), limit=ltb)
        if res is not None:
            test_eer = results["test_eer"] = res["eer"]
            results["test_mdc"] = res["mdc"]
    if results:
        logger.log_eval(int(state.step), {**results, "test_seconds": time.perf_counter() - t0}, split="test")
    if test_eer is None:
        test_eer = validate(state)["val_eer"]  # before the logger closes: it logs the tracked transcription
    logger.close()
    return float(test_eer)
