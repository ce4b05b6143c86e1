"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc`` (``$CUDA_HOME/bin`` or on ``PATH``). Phases, each of which fails
the run by raising:

1. card: ``nvidia-smi`` name and power limit;
2. build: every CUDA kernel of the main paths, from ``csrc/`` with one
   ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on the card: the
   attention forward (output and LSE, and the inference path at rate 0),
   dq and dk/dv, at the BASE training shape, a ragged 30 s shape and a
   64 s shape, in float32 and bfloat16, at dropout rates 0 and 0.1, and at
   LARGE's training shape (H=16, bf16, rate 0.1); the fused strided conv
   over conv layers 1-6 at the BASE (B=66, no bias, no LN) and LARGE
   (B=48, bias + LN) training shapes and on ragged short inputs, in float32
   and bfloat16; each with kernel, plain, bound and library times, and at
   each attention shape the dq + dk/dv pair beside SDPA's backward (timed
   alone on a retained graph, ``backward_ms``); the pair launched twice
   bit for bit, and in float32 each of dq, dk and dv within
   ``ATTN_F64_FACTOR`` times the plain version's distance from a float64
   evaluation (``fa.attention_bwd_float64``); float32 bounds count each
   product as 3xTF32 (``product_s``), the SIMT time printed beside;
4. serving main path: ``entry()`` (wav2vec2-BASE, mean pooling, FC head;
   bf16, B=48 x 48 000 samples), its launch counts, its speed, and a float32
   check of the same weights against the CPU on a small padded batch;
5. serving: 12 utterances of 3.2-64 s through ``extract_embeddings``
   (buckets of 16 000 samples, batch 4), each embedding held against the
   utterance's own unpadded batch-1 embedding (``padding_ratio``), then 20
   pair scores;
6. training main path: ``train_entry()`` (the ``speaker_wav2vec2_ce``
   recipe at full BASE width, B=66 x 48 000, bf16 autocast over float32
   parameters, every regularisation on): warm-up, then 12 timed steps,
   the launches of each kernel against the layers each step kept, the
   loss finite, the parameters moved, peak memory and the device profile;
7. a float32 training step at full width (2 layers), card against CPU,
   from the same weights and generator seed with dropout on: loss and
   gradients agree;
8. overfit: 30 steps on one batch at a constant learning rate; the loss
   falls;
9. LARGE serving: wav2vec2-LARGE with the AAM head and
   ``conv_impl="fused_pallas"`` (bf16, B=48 x 48 000): launches (conv 6,
   attention forward 24), speed, a float32 check against the CPU, the
   ``conv_impl="xla"`` route's embeddings within the bf16 limit, and
   padding invariance of bucketed serving;
10. LARGE training main path: ``large_train_entry()`` (the
   ``speaker_wav2vec2_large_aam`` recipe with the fused conv, B=48 x 48 000,
   bf16 autocast, the recipe's ``trainer.remat``, each kept layer recomputed
   whole under any ``remat_policy``):
   warm-up, 12 timed steps, 6 conv launches and kept-layer attention
   launches per step (the forward twice: the layers are recomputed in the
   backward), the AAM accuracy metric, peak memory and the device profile;
11. a float32 LARGE-width step (2 layers, the conv stack whole), card
   against CPU, dropout on: loss and gradients agree;
12. predict end to end: ``w2v2_speaker_tpu_torch.predict.main`` (the
   ``predict.py`` twin over ``config/predict.yaml``) on 24 synthetic 16 kHz
   WAV files of 2-30 s in VoxCeleb-style paths (6 speakers) and a labelled
   trial file, at full LARGE width with ``network.conv_impl=fused_pallas``,
   bf16, buckets of 16 000 samples, batch 4, from a seeded LARGE + AAM
   ``state_dict`` file: one score in [0, 1] per pair, equal to the cosine
   evaluator's over ``extract_embeddings`` of the same files called
   directly; 24 attention-forward and 6 conv launches per bucket batch; a
   second run served from the embedding cache with no launch; EER and
   minDCF of the labelled trials in [0, 1]; the fused conv (layers 1-6)
   and the attention forward (first and last layer) against their plain
   versions on the inputs the longest bucket batch gave them; then 4 files
   of <= 3 s in float32 on the card and on the CPU, scores within 1e-4;
   utt/s and the real-time factor from the median of 10 warm extractions;
13. run end to end: ``w2v2_speaker_tpu_torch.run.main`` (the ``run.py``
   twin over ``config/train_eval.yaml``) with ``+experiment=speaker_wav2vec2_ce``
   at full BASE width, random init, bf16, B=66, on a corpus the phase
   writes (50 speakers x 6 WAV files of 3.5-5 s, a trial file over 3 test
   speakers, 3 validation speakers, shards of 22): shards, sanity and
   interval validations, 8 steps in dispatches of 4, checkpoints, the test
   EER; then resumed to step 12. The objectives are EERs in [0, 1],
   ``index.json`` names a best and the last checkpoint, the resumed run
   logs steps 9-12, every step launches the forward, dq and dk/dv once per
   kept layer, and one layer's q/k/v from a training batch holds the
   forward and the dq + dk/dv pair against their plain versions; prints
   shard preparation time, steady ms/step (CUDA events, steps 5-8), the
   host's wait on the prefetcher per step, the device's busy share over
   one profiled dispatch, validation and test wall time and the peak
   memory above what was allocated when the phase began;
14. pairs end to end: ``run.main`` with ``+experiment=speaker_wav2vec2_pairs``
   (the paper's w2v2-bce recipe: one BASE encoder over ``[CLS, a, SEP, b,
   SEP]``, T = 3 + 2 x 149 = 301 at 3 s crops, BCE) at full width, random
   init, bf16, B=32 pairs, on phase 13's corpus in shards of 24 (runs of 4
   per speaker), 8 steps in dispatches of 4 across an epoch boundary with
   sanity and interval validations (the validation pairs scored through
   the network), checkpoints, and the test trials scored on full-utterance
   pairs. Checks: the EER in [0, 1], best and last checkpoints, 16
   positives and 16 negatives in every step, launches = kept layers in
   every step, layer 0's q/k/v of a paired training batch through the
   forward and dq + dk/dv against their plain versions (then timed there
   beside their bounds and SDPA), the test scores equal to ``score_fn``
   called on the same batches; prints steady ms/step, the host's wait,
   the busy share of a profiled dispatch, validation and test wall time,
   the trials and their longest T, and the phase's own peak memory;
15. the pooling zoo at full BASE width: ``compute_embedding`` of every
   ``stat_pooling_type`` but ``mean`` in float32, card against CPU; the
   bucketed-vs-unpadded distance ratio of bf16 serving for ``first+cls``,
   ``attentive`` and ``quantile``; then ``run.main`` (``speaker_wav2vec2_ce``,
   4 steps) with ``attentive`` pooling (its BatchNorm's running statistics
   moved and restored with the best checkpoint) and with ``first+cls``
   (attention at T=150), launches = kept layers in every step;
16. speech end to end: ``run.main`` with ``+experiment=speech_wav2vec2_ctc``
   (wav2vec2-BASE + CTC letter head, random init, bf16, the recipe's token
   budget of 3.2 M samples a batch, buckets of 16 000 samples,
   ``tri_stage``) on a LibriSpeech-layout corpus it writes (88 training
   utterances of 2-24 s, four eval splits of 8 of 2-35 s, random-word
   transcripts): 8 steps across an epoch boundary, a sanity validation and
   validations every 4 on both validation splits, best-k by ``val_wer``,
   the test WER of both test splits. Checks: WERs finite and >= 0, the
   index ranked by ``val_wer``, launches = kept layers in every step, the
   longest training batch at T > 1000; layer 0's q/k/v of that batch
   (dropout on) through the forward and dq + dk/dv, and of the longest
   eval batch through the forward, against their plain versions, then
   timed there beside their bounds and SDPA; a float32 CTC step (2 layers
   at full width, 3 padded rows with labels of 40, 25 and 9 tokens) card
   against CPU. Prints each step's B, T and ms, audio s per s over steps
   5-8, the host's wait, the busy share and device ms by category of step
   3 (profiled), and the phase's own peak memory;
17. speaker CTC end to end: ``run.main`` with
   ``+experiment=speaker_wav2vec2_ctc`` (frame-level CTC over 5994 + 1
   classes, the blank's bias 100, ``[66, 149, 5995]`` float32 logits) on
   phase 13's shards: 4 steps in one dispatch, finite losses, launches =
   kept layers, the mean-pooled test EER in [0, 1];
18. multitask end to end: ``run.main`` with ``+experiment=multitask_wav2vec2``
   (one BASE backbone under the CTC letter head and the speaker CE head,
   random init, bf16, the 3.2 M-sample token budget, ``tri_stage``) on phase
   16's training split and eval splits of 8 utterances over 2 speakers: 8
   steps across an epoch, validations at 4 and 8 (both validation WERs and
   the EER of 16 speaker trials), best-k by ``val_eer`` (as the JAX package
   ranks every kind but speech), both test WERs and the test EER; then 4
   steps with ``optim/loss=ctc_aam``; then the predict twin on the best
   checkpoint (``network.explicit_vocab_size``). Checks: each step's loss
   equal to loss_speech + loss_speaker, both finite, launches = kept layers,
   WERs >= 0, EERs in [0, 1], the attention kernels at the longest training
   batch's layer-0 inputs (dropout on) against their plain versions, then
   timed there; the predict scores equal to ``extract_embeddings`` + the
   cosine evaluator. Prints each step's B, T and ms, audio s per s over
   steps 5-8, the host's wait, step 3's profile and the phase's peak memory;
19. triplets end to end: ``run.main`` with ``+experiment=speaker_wav2vec2_triplet``
   and ``speaker_wav2vec2_triplet_ce`` at full BASE width, bf16, B=66, on
   a corpus of phase 13's layout with 8 utterances a speaker, in shards of
   the recipe's runs of 4 (every sample kept: 5 batches an epoch) and a
   sample queue of 100, below the epoch's 352, so that batches are drawn
   while samples still stream in; 4 steps in one dispatch each, triplets
   mined on the card: every batch holds >= 2 speakers and >= 2 samples of
   each, drawn before the epoch's last sample arrived, finite losses,
   launches = kept layers, the test EER in [0, 1]; ms/step and the peak
   memory;
20. item 5's options on phase 13's shards: (a) ``network.wav2vec_feature_encoder_only=true``
   with ``network.conv_impl=fused_pallas`` (the conv stack alone), 4 steps:
   6 conv launches and no attention launch a step, the conv kernel against
   its plain version at the first training batch's own layer inputs (then
   timed there), ms/step, step 4 under torch.profiler (device ms by
   category, the ops with the most device time and memory), the memory
   held after each forward and each step's peak; (b) ``network.use_transformers_as_ensembles=true``
   with 12 ensembles at the test (``fit_model=false``): 12 pooled
   embeddings per utterance, each trial's score the mean of the 12
   per-layer cosine scores, the test EER, and float32 ensemble embeddings
   card against CPU; (c) ``network.stat_pooling_type=none`` with the test
   pooling ``none``: ``[T, D]`` test embeddings scored by the frame-level
   cosine, the EER in [0, 1];
21. the fbank and its frontend in float32, card against CPU: phase 5's 12
   utterance lengths (3.2-64 s) in buckets of 16 000 samples, batch 4,
   ``log_mel_filterbank`` with lengths and ``FbankFrontend`` at 40 and 80
   mels over the valid frames, each padded row's frames against the row
   alone, ms per batch, and a full-width x-vector's bucketed embeddings
   against each utterance alone (``padding_ratio``);
22. ``run.main`` with ``+experiment=speaker_xvector`` at full width (TDNN
   512 x 4 + 1500, 40 mels, 512-d, float32, B=66 x 3 s) on phase 13's
   shards: a sanity validation, 4 steps in one dispatch, a validation, the
   test; steady ms/step, the busy share and device ms by category of the
   profiled step 4, peak memory, no kernel launched; then one float32 step
   at B=3 padded to 2 s, card against CPU: loss, gradients and the updated
   running statistics;
23. the same with ``+experiment=speaker_ecapa_tdnn`` (channels 1024 x 4 +
   3072, 80 mels, AAM, 192-d), then the predict twin on the run's best
   checkpoint over 6 of phase 12's files in buckets: the scores against
   ``extract_embeddings`` + cosine, the bucketed embeddings against each
   file alone (``padding_ratio``);
24. ``+experiment=speaker_wav2spk`` with the multi-step schedule's
   milestones at steps 2 and 3 (each step's learning rate against
   ``multi_step_decay``) and its float32 step card against CPU, then
   ``+experiment=speaker_dummy`` with its ``trainer=debug_trainer``;
25. the native DSP library of the augmentations (``native/dsp.cpp``, built
   by ``utils/native.py``): ``upfirdn``, ``fir_same``, ``fft_convolve`` and
   ``speed_perturb_native`` against scipy within ``tests/test_native.py``'s
   limits, each timed beside scipy on a 5 s clip (host);
26. the x-vector augmentation study: ``run.main`` with ``+experiment=speaker_xvector``
   (full width, f32, B=66 x 3 s, 4 steps) on phase 13's shards with
   ``xvector_all_augment_pipeline``, ``xvector_dropout_augment_pipeline`` and
   ``xvector_rirs_augment`` (over synthetic ``pointsource_noises`` shards
   the phase writes): each run as phase 22's, beside the host pipeline's ms
   per batch over an epoch at 1 and 4 pipeline workers;
27. the flagship recipe on augmented batches: ``+experiment=speaker_wav2vec2_ce``
   at full BASE width (bf16, B=66) with ``xvector_dropout_augment_pipeline``,
   ``trainer.dump_first_batch=true`` and ``verify_model=true``, 4 steps:
   launches = kept layers in every step, finite losses, layer 0's training
   q/k/v through the forward and dq + dk/dv against their plain versions,
   the leakage probe passed on the card, the dump's collated batch and 4
   samples' stages (original, each effect, chunk, normalised);
28. wav2vec v1 at its published width (512 x 5 strided convs): ``network=wav2vec_fc``
   (mean), with mean+std and the 9-layer aggregator, and ``wav2vec_xvector``,
   f32, B=66 x 3 s under ``run.main`` (4 steps, no kernel launched) and the
   predict twin on each best checkpoint (as phase 23's), and for the last two
   the float32 step card vs CPU against a float64 CPU step (as phases 22-24);
29. optimizers and schedules: ``run.main`` on ``speaker_wav2vec2_ce`` at
   full BASE width (bf16, B=66) on phase 13's shards, 4 steps, under (a)
   SGD with ``schedule_wav2vec_fan_etal`` (cyclic), (b) AdamW with
   ``exp_decay`` and (c) ``reduce_on_plateau`` with patience 0 and a
   validation every step: each update's rate equal to the port's schedule
   (for (c), the controller replayed on the logged validation EERs, its
   state in the last checkpoint) and held by the torch optimizer, finite
   losses, launches = kept layers, ms/step; (d) one step of the LARGE AAM
   recipe on the fused conv (B=48) with float32 and with bfloat16 first
   moments: the moment's dtype, the optimizer state's bytes, the step's
   peak memory and time, 6 conv and kept-layer attention launches, the
   updated parameters within 4 float32 ulps and the stored bf16 moments
   bit-equal to a plain float32 recompute of the rule (optax's for the
   bf16 moment, torch's for float32);
30. the LR range test: ``run_lr_range_test=true tune_iterations=40`` on the
   BASE recipe at full width on phase 13's shards: ``data.json`` (``lr``,
   ``loss``, ``suggestion``), each step's rate the float32 table's entry,
   the suggestion one of the rates, launches = kept layers, ms/step;
31. the progress tracker (``callbacks=speaker_progress_tracker``) on the
   BASE recipe (bf16) and on ``speaker_xvector`` (float32), 4 steps with
   validations at 2 and 4: one snapshot per validation, its
   ``embeddings.npy`` of [5 x 2, D] equal to ``compute_embedding`` of the
   same model on the same probe batch within 1e-6, the separation metrics
   logged beside ``val_eer`` and finite, the BASE snapshot's attention
   forward launched once per layer;
32. the run surface at full BASE width, 2 steps a run: a ``-m
   network.stat_pooling_type=mean,max`` grid (two objectives, two
   checkpoint directories), ``-m +search=lr_and_pooling`` with 3 trials
   (each trial's overrides those of the port's TPE sampler replayed with
   the logged objectives, the best printed, the memory at each trial's
   start), ``hydra/launcher=slurm`` on a 2-point grid (the array script
   written without ``sbatch``, its tasks running ``-m
   w2v2_speaker_tpu_torch.run`` in ``job<i>`` directories) and ``-sc`` of
   both twins;
33. the int8 kernels (``csrc/int8_matmul.cu``: the row quantize and the
   GEMM with its rescale epilogue) against their plain versions, bit for
   bit, at LARGE's five dense sites with M from phase 12's longest bucket
   batch, at BASE's at B=48 x 3 s and at a ragged M, N, K, each with
   kernel, plain, bound and library (``torch._int_mm`` + the rescale) ms,
   the share of the bound each kernel reaches and the GEMM's tile; the
   bf16 ``F.linear`` of LARGE's five sites, what int8 serving competes
   with;
34. int8 serving end to end: ``predict.main`` with ``network.int8_matmuls=true``
   on phase 12's files at full LARGE width on the fused conv (scores within
   0.02 of phase 12's bf16 ones, 97 GEMMs, 194 quantizes, 24 attention
   forwards and 6 convs per bucket batch, warm utt/s beside phase 12's);
   BASE with ``auto`` on buckets on both sides of the threshold (the
   routing line as ``int8_auto_policy`` says); BASE full precision against
   int8 at 3, 6 and 12 s (the card's crossover); ``run.main`` eval-only
   with int8 from phase 13's best checkpoint;
35. the knobs: ``trainer.deterministic=true`` on the BASE CE recipe, 4
   steps twice in fresh processes (losses and parameters bit-equal,
   ms/step beside a run without it and phase 13's), every other recipe one
   step under it, the CTC ones included; ``profiler=simple`` over
   12 steps (its window's steps and the attention kernels in the trace, no
   sanity validation); ``trainer.remat`` on the LARGE AAM step under each
   policy, all three full recompute (loss, gradients, generator bit-equal
   to no remat; peak memory and ms/step);
36. data parallelism: (a) i the three attention kernels on a block of rows
   and on a block of heads at their global coordinates, bit-equal to the
   same rows (heads) of the global launch (bf16 and f32, rate 0.1, LARGE's
   and a speech shape); ii the BASE CE recipe through ``run.main`` for 4
   steps on 2 gloo ranks sharing the card against 1 rank (step-1 loss
   within 1.5e-3 relative, steps 2-4 within 1e-3, replicas bit-identical
   after every step, attention launches per rank = kept layers, ms/step and
   the all-reduce's ms); iii a float32 2-layer BASE-width step on 2 ranks
   against 1 (loss within 1e-5, each gradient within ``DP_F32_GRAD_REL`` of
   the 1-rank gradient's norm), each rank's share of it in one process
   (``split_step_case``), both again with cuDNN's TF32 on (the distance
   the ranks once read without full float32 set), and on 1 NCCL rank;
37. tensor parallelism: ``dryrun_multichip(4)`` at BASE width, dp=2 x tp=2
   over gloo on the card, 6 heads a rank, against one process (the frozen,
   released and post-restore losses within 1e-5, the released step's
   gathered gradients within ``TP_GRAD_REL``);
38. multi-rank predict: phase 12's LARGE predict (fused conv, bf16, the
   same 24 files) with ``trainer.num_devices=2`` on 2 gloo ranks sharing
   the card (a group made here): scores within 2e-3 of phase 12's and in
   its pair order, rank 0 alone saving the cache and printing, 24
   attention forwards and 6 convs a rank a bucket batch; the float32
   sub-case (4 files of <= 3 s) within 1e-5 of 1 rank; warm utt/s of both
   (printed, not held: two ranks share one card); with 2 or more cards the
   same over NCCL, a card a rank, at 2 and at every card;
39. the CTC kernels (``csrc/ctc_loss.cu``): (a) the forward
   (``ctc_alpha_beta``: the alpha and beta chains in one launch) and the
   backward (``ctc_grad``) against their plain versions at phase 16's longest
   training batch, at phase 17's shape, on a ragged batch with repeated
   letters, an infeasible and an empty-label row, and on two rows of
   1100-token labels (two pairs of states a thread) (loss 1e-5 relative,
   logit gradient 1e-6 absolute on feasible rows with the main path's
   upstream weights, exact zeros on infeasible rows and past each row's
   frames, two launches bit-equal, one launch a call), each kernel's
   ms beside its plain version's, its bound's and ``F.ctc_loss``'s, a
   training step's forward + backward beside ``F.ctc_loss``'s, and the
   chains' us a frame; (b)
   ``speech_wav2vec2_ctc``, ``speaker_wav2vec2_ctc`` and ``multitask_wav2vec2``
   4 steps each under ``trainer.deterministic=true`` in two fresh processes
   (losses and parameters bit-equal), ms/step beside the same runs without
   it; (c) phase 16's speech step at its longest batch through the kernels
   and through ``F.ctc_loss`` in one call (the route before this kernel);
40. the float32 training path: ``speaker_wav2vec2_ce`` with
   ``trainer.precision=f32`` at full BASE width (B=66 x 48 000 samples)
   through the recipe entry (``_recipe_entry``): a warm-up dispatch, two
   timed dispatches of 4 steps, each float32 attention kernel launched once
   a kept layer in every step, finite losses, the parameters moved, ms/step,
   peak memory, one profiled dispatch's device ms by category (the attention
   backward's among them), and layer 0's q/k/v and upstream gradient from a
   training step through the forward and dq + dk/dv against their plain
   versions, twice bit for bit and within the float64 rule of phase 3;
41. one JSON line with every kernel's numbers (the attention kernels and
   the conv at the LARGE training shapes, launches of the LARGE training
   run; the int8 kernels over LARGE's five sites, launches of phase 34's
   LARGE int8 predict run; the CTC kernels, the forward and the backward,
   at phase 16's longest training batch, launches of phase 16's run; the
   float32 attention kernels at BASE's training shape, rate 0.1, launches
   of phase 40's run, and the float32 conv at LARGE's, launches of phase
   11's step), the card line, then the result line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import copy
import gc
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from w2v2_speaker_tpu_torch import predict
from w2v2_speaker_tpu_torch.data.collate import collate_pad_right
from w2v2_speaker_tpu_torch.data.features import FbankConfig, log_mel_filterbank, num_frames
from w2v2_speaker_tpu_torch.data.io import load_raw_audio, write_wav
from w2v2_speaker_tpu_torch.data.normalize import normalize_waveform
from w2v2_speaker_tpu_torch.data.samples import PairedSample, SpeakerSample, collate_paired_batch
from w2v2_speaker_tpu_torch.data.tokenizer import CharTokenizer
from w2v2_speaker_tpu_torch.data.trials import (
    generate_validation_pairs, load_evaluation_pairs, save_evaluation_pairs,
)
from w2v2_speaker_tpu_torch.device import set_float32_precision
from w2v2_speaker_tpu_torch.entry import (
    BATCH, NUM_SPEAKERS, SAMPLES, _recipe_entry, build_model, build_train_state, dryrun_multichip, entry,
    large_train_entry, synthetic_batch, train_entry,
)
from w2v2_speaker_tpu_torch.models.frontend import FbankFrontend
from w2v2_speaker_tpu_torch.models.wav2vec2 import (
    BASE_CONFIG, LARGE_CONFIG, Wav2Vec2Config, feat_extract_output_lengths, init_parameters,
)
from w2v2_speaker_tpu_torch.models.wav2vec2_speaker import Wav2Vec2SpeakerConfig, Wav2Vec2SpeakerModel
from w2v2_speaker_tpu_torch.models.wav2vec2_speech import Wav2Vec2SpeechConfig, Wav2Vec2SpeechModel
from w2v2_speaker_tpu_torch.objectives.schedules import multi_step_decay
from w2v2_speaker_tpu_torch.ops import _build
from w2v2_speaker_tpu_torch.ops import conv_encoder as ce
from w2v2_speaker_tpu_torch.ops import ctc
from w2v2_speaker_tpu_torch.ops import flash_attention as fa
from w2v2_speaker_tpu_torch.ops import quant
from w2v2_speaker_tpu_torch.eval.evaluator import CosineDistanceEvaluator, EmbeddingSample
from w2v2_speaker_tpu_torch.runtime.config import load_config
from w2v2_speaker_tpu_torch.runtime.experiment import (
    CONFIG_DIR, build_model_and_task, build_optimizer, load_recipe, speech_model_config,
)
from w2v2_speaker_tpu_torch.runtime.predict import build_predict_model, extract_embeddings
from w2v2_speaker_tpu_torch.train.paired_task import PairedSpeakerTask
from w2v2_speaker_tpu_torch.train.speaker_task import SpeakerTask
from w2v2_speaker_tpu_torch.train.speech_task import SpeechTask
from w2v2_speaker_tpu_torch.train.state import AdamTx, SgdTx, TrainState
from w2v2_speaker_tpu_torch.train.steps import make_train_step

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores,
# float32 and float64 outside the tensor cores, HBM3. A float32 product that
# keeps float32 accuracy on the tensor cores takes three TF32 products
# (3xTF32: hi.lo + lo.hi + hi.hi, as the f32 attention backward kernels run
# them), so the float32 products of the attention kernels and the conv are
# bounded at 3 x FLOPs over the TF32 peak (`product_s`), the SIMT time at
# PEAK_OPS[float32] printed beside it; PEAK_OPS[float32] stays the bound of
# float32 elementwise work (the fbank), float64 that of the CTC recursions
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.float64: 34e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
H, D = 12, 64  # wav2vec2-BASE attention
H_LARGE, LARGE_BATCH = 16, 48  # wav2vec2-LARGE attention; the LARGE recipe's batch
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "conv_encoder", "int8_matmul", "ctc_loss")
KERNELS = (  # (name in the kernels line, source, the TPU kernel it replaces)
    ("flash_attention_fwd", "flash_attention_fwd", "w2v2_speaker_tpu/ops/flash_attention.py:204"),
    ("flash_attention_bwd_dq", "flash_attention_bwd", "w2v2_speaker_tpu/ops/flash_attention.py:381"),
    ("flash_attention_bwd_dkv", "flash_attention_bwd", "w2v2_speaker_tpu/ops/flash_attention.py:465"),
    ("conv_encoder", "conv_encoder", "w2v2_speaker_tpu/ops/conv_encoder.py:120"),
    ("int8_quantize", "int8_matmul", "w2v2_speaker_tpu/ops/quant.py:83 (XLA, not Pallas)"),
    ("int8_gemm", "int8_matmul", "w2v2_speaker_tpu/ops/quant.py:83 (XLA, not Pallas)"),
    ("ctc_alpha_beta", "ctc_loss", "w2v2_speaker_tpu/objectives/losses.py:176 (optax, XLA, not Pallas)"),
    ("ctc_grad", "ctc_loss", "w2v2_speaker_tpu/objectives/losses.py:176 (optax, XLA, not Pallas)"),
)
ATTENTION = KERNELS[0][0], KERNELS[1][0], KERNELS[2][0]
# the float32 kernels of the same sources (each source's f32 instantiation):
# the attention kernels on phase 40's float32 BASE training path, the conv
# on phase 11's float32 LARGE step
KERNELS_F32 = tuple((f"{name}_f32", source, replaces) for name, source, replaces in KERNELS[:4])
# the fused conv vs its plain version: ce.kernel_tolerance (f32: the JAX
# kernel tests' 2e-4 / 2e-5; bf16: rtol 2e-2, atol 2^-5 of the RMS of the
# plain output). Ragged short inputs (T_in, k) at C=512, B=2, bias + LN:
# T_out 48, 47 and 10, none a multiple of the kernel's frame tiles
CONV_RAGGED = ((97, 2), (97, 3), (21, 3))
# kernel vs plain, on valid rows: fa.kernel_tolerance (f32: the JAX kernel
# tests' 2e-4 / 2e-5 forward, 5e-4 / 5e-5 backward; bf16: rtol 2e-2, atol
# 2^-5 of the outputs' RMS); the LSE is float32 in both types: 2e-4 / 2e-5
ATTN_SHAPES = [  # (name, B, T, lengths)
    ("train_3s", 66, 149, [149] * 66),
    ("ragged_30s", 8, 1504, [1504, 1500, 1337, 1023, 777, 64, 1, 0]),
    ("long_64s", 2, 3200, [3200, 2911]),
]
RATES = (0.0, 0.1)
DROPOUT_SEED = -123456789
LSE_RTOL, LSE_ATOL = 2e-4, 2e-5
# float32 dq, dk and dv against a float64 evaluation of the same formulas
# (fa.attention_bwd_float64): the kernel's norm of the error over the norm
# at most this many times the plain float32 version's (the float32
# networks' rule, FAMILY_F64_FACTOR). It catches products short of float32
# accuracy that kernel_tolerance passes at short rows (1xTF32:
# tools/torch_fault_probe.py)
ATTN_F64_FACTOR = 4.0
ROOT = pathlib.Path(__file__).resolve().parent
MEASURED = {}  # numbers a later phase prints beside its own
UTTERANCE_S = [3.2, 4.0, 4.7, 6.1, 7.8, 8.4, 11.9, 15.3, 19.8, 26.5, 38.0, 64.0]
# bucketed vs unpadded batch-1 embeddings in bf16 (other batch shapes take
# other GEMM and conv tilings, so bf16 roundings differ through 12 layers):
# the largest distance between an utterance's two embeddings, over the
# smallest distance between two utterances' unpadded embeddings. An
# embedding handed back to the wrong utterance reads >= 1.
MAX_PAD_RATIO = 0.35  # read 0.13 as built, 1.02 swapped (tools/torch_fault_probe.py)
# float32 card vs CPU: same math, other summation orders and conv algorithms
F32_REL_TOL = 1e-3
TRAIN_DISPATCHES = 3  # x 4 steps per dispatch, timed
OVERFIT_STEPS, OVERFIT_BATCH, OVERFIT_LR = 30, 8, 3e-4
OVERFIT_MIN_FALL = 1.0  # nats of CE, mean of the first 3 steps minus the last 3
# predict end to end: 24 files of 2-30 s over 6 speakers, ~60 labelled trials
PREDICT_SPEAKERS, PREDICT_FILES, PREDICT_TRIALS = 6, 24, 60
PREDICT_BATCH, PREDICT_PAD = 4, 16000  # data.dataloader.test_batch_size / test_pad_to_multiple
PREDICT_F32_S = (2.0, 2.4, 2.7, 3.0)  # the float32 card-vs-CPU folder
# the written scores against the direct extract_embeddings + cosine evaluator
# (the same model and batches; bf16 kernels are deterministic)
PREDICT_SAME_ATOL = 1e-6
PREDICT_F32_ATOL = 1e-4  # float32 scores, card vs CPU
PREDICT_ATTN_LAYERS = (0, -1)  # layers whose attention inputs are held against the plain version
PREDICT_TIMED = 10  # warm extractions timed one by one
# run end to end: 50 speakers x 6 utterances (3 sessions x 2) of 3.5-5 s;
# 3 speakers for the test trials, 3 held out for validation, the other 44
# give 264 training utterances: 4 batches of 66 per epoch, in 12 shards of 22
RUN_SPEAKERS, RUN_TEST, RUN_VAL, RUN_SHARD = 50, 3, 3, 22
RUN_STEPS, RUN_VAL_EVERY, RUN_RESUMED_STEPS = 8, 4, 12
RUN_ATTN_LAYER = 0  # the layer whose training inputs are held against the plain versions
# pairs end to end on phase 13's corpus: shards of 24 (a multiple of the
# recipe's runs of k=4; each training speaker gives one run of 4, so an
# epoch holds 5 pair batches of 32), 8 steps across an epoch boundary
PAIRS_SHARD, PAIRS_STEPS, PAIRS_VAL_EVERY, PAIRS_BATCH = 24, 8, 4, 32
PAIRS_SAME_ATOL = 1e-6  # the test phase's scores vs score_fn on the same batches (same model, same kernels)
PAIRS_F32_SIDES = ((48000, 20000), (31000, 48000), (16000, 9000))  # samples of side a, side b per f32 pair
# the pooling zoo: every stat_pooling_type the JAX package trains with but "mean" (phase 4's)
POOLINGS = ("mean+std", "max", "quantile", "attentive", "first", "first+cls", "middle", "last", "random")
POOL_PADDING = ("first+cls", "attentive", "quantile")  # held to MAX_PAD_RATIO in bucketed bf16 serving
# each pooling run: POOL_STEPS steps, a validation every POOL_VAL_EVERY; the
# attentive one in two legs (the second resumed), its first leg's best pinned
POOL_STEPS, POOL_VAL_EVERY = 4, 2
# speech end to end (LibriSpeech layout): 88 training utterances of 2-24 s
# over 12 speakers (1127 s at seed 16: 7 batches of the recipe's
# 3.2 M-sample budget, T up to 1199, so 8 steps cross an epoch), four eval
# splits of 8 utterances of 2-35 s; transcripts of random words at ~12
# characters a second
SPEECH_TRAIN, SPEECH_TRAIN_S, SPEECH_EVAL, SPEECH_EVAL_S = 88, (2.0, 24.0), 8, (2.0, 35.0)
SPEECH_CHARS_PER_S = 12
# the profiled step (counted from 0) lies before the timed steps 5-8: starting
# and stopping the profiler costs host time that the timed window would hold
SPEECH_STEPS, SPEECH_VAL_EVERY, SPEECH_PROFILED = 8, 4, 2
SPEECH_F32_LABELS = (40, 25, 9)  # tokens of the f32 CTC step's rows of 32 000, 21 000 and 9 000 samples
SPEAKER_CTC_STEPS = 4
# multitask end to end: phase 16's training split and seed, so the same 7
# batches an epoch as the speech run; eval splits of 8 utterances over 2
# speakers (4 each: 12 same-speaker pairs a split), 16 trials drawn from the
# first validation and the first test split; 8 ctc_ce steps (step 3
# profiled), then 4 ctc_aam steps; the predict twin on the best checkpoint
MT_EVAL_SPEAKERS, MT_VAL_PAIRS = 2, 16
MT_STEPS, MT_VAL_EVERY, MT_PROFILED, MT_AAM_STEPS = 8, 4, 2, 4
MT_LOSS_RTOL = 1e-6  # loss against speech_weight x loss_speech + speaker_weight x loss_speaker (one float32 sum)
MT_SAME_ATOL = 1e-6  # the predict twin's scores vs extract_embeddings + cosine evaluator on the same model
# triplets end to end on a corpus of phase 13's layout with 8 utterances a
# speaker: the recipe's runs of 4 keep all 352 training samples (5 batches
# of 66 an epoch, so one dispatch of 4 steps); a queue of 100 samples makes
# the processor draw while the epoch still streams in; 4 steps of each
# triplet recipe
TRIPLET_UTTERANCES, TRIPLET_QUEUE, TRIPLET_STEPS = 8, 100, 4
# item 5's options on phase 13's shards: the conv stack alone on the fused
# conv (4 steps), 12 layer ensembles (test only), frame-level test embeddings
LITE_STEPS, ENSEMBLES, FRAMES_STEPS = 4, 12, 2
TOP_OPS = 6  # ops listed from a profile with memory, by device time and by memory
ENSEMBLE_SAME_ATOL = 1e-6  # the ensemble score vs the mean of the 12 per-layer cosine scores
ENSEMBLE_F32_S = (1.2, 2.0, 3.0)  # the float32 card-vs-CPU ensemble utterances
# the networks off the wav2vec2 backbone, float32 (phases 21-24). Log-mel and
# normalised features card vs CPU over the valid frames: 1e-3 abs
# (tests/test_torch_features.py, JAX vs port: 2.3e-5 as built, a periodic
# window 0.036, reflection at the batch edge 2.2)
FBANK_ATOL = 1e-3
FBANK_BATCH, FBANK_PAD = 4, 16000
FAMILY_STEPS = 4  # one dispatch of the recipes' steps_per_dispatch
FAMILY_F32_LENGTHS = (32000, 21000, 9000)  # the float32 card-vs-CPU step's rows, padded to 2 s
# gradients that are 0 in exact arithmetic (a bias before a normalisation or
# a softmax over time) read their rounding: their errors count against this
# share of the largest gradient (tests/test_torch_speaker_families.py's floor)
FAMILY_GRAD_FLOOR = 1e-3
# the float32 gradients of these networks at B=3 lie up to ~2e-3 from the
# float64 step's (norm of the error over the norm), on the CPU too: the
# BatchNorm and instance-norm backwards subtract near-equal terms. The
# card's may lie this many times as far: as built it reads 2.1x (x-vector),
# 1.04x (ECAPA) and 0.8x (wav2spk) the CPU's, with TF32 allowed 123x, 56x
# and 45 000x (tools/torch_fault_probe.py --families, H100 80GB HBM3 at 700 W)
FAMILY_F64_FACTOR = 4.0
FAMILY_F32_SEEDS = {"speaker_xvector": 22, "speaker_ecapa_tdnn": 23, "speaker_wav2spk": 24,
                    "wav2vec_fc_meanstd_agg": 28, "wav2vec_xvector": 29}
FAMILY_PREDICT_FILES = 6  # of phase 12's files, served from the ECAPA run's best checkpoint
WAV2SPK_MILESTONES = (2, 3)  # the learning rate falls twice within the 4 steps
OPTIM_STEPS = 4  # phase 29's runs: steps, a validation every 2 (6 steps, a validation each, under reduce_on_plateau)
OPTIM_RUNS = (  # (label, overrides)
    ("sgd + schedule_wav2vec_fan_etal", ["optim/algo=sgd", "optim/schedule=schedule_wav2vec_fan_etal"]),
    ("adamw + exp_decay", ["optim.algo.weight_decay=1e-2", "optim/schedule=exp_decay"]),
    ("adam + reduce_on_plateau", ["optim/schedule=reduce_on_plateau", "optim.schedule.patience=0",
                                  "trainer.val_check_interval=1", "trainer.max_steps=6"]),
)
# phase 29d: the updated parameters against a plain per-tensor float32
# recompute of the Adam rule from the same gradients, in float32 ulps of
# max(|before|, |after|) (an update can cancel the parameter to near 0):
# the bf16-moment update is the recompute's operations batched (reads 0-1
# on the CPU); torch's float32 Adam is recomputed in its own grouping
# (lerp, lr / bc1 in float64, sqrt(v) / sqrt(bc2)), and optax's grouping
# lies up to 12.5 ulps from it on an H100, which the CPU tests bound
# (tests/test_torch_optim.py). The stored bf16 first moments must equal
# the recompute's bit for bit: b1 unrounded (0.16 % off) flips many of
# them, while it moves a parameter by less than an ulp
MU_PARAM_ULPS = 4
LR_ITERATIONS = 40  # phase 30's tune_iterations
SNAPSHOT_ATOL = 1e-6  # phase 31: a snapshot's embeddings vs the embed path on the same model and probe batch
SEARCH_TRIALS = 3  # phase 32's +search, 2 of them from the prior


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device ms per call: CUDA events around ``reps`` calls, queued behind
    a ~10 ms sleep kernel so that the host's enqueue cost (the Python
    wrapper, small tensor set-up) is hidden wherever the device work is
    the longer of the two."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def backward_ms(out, inputs, grad, reps: int, warmup: int = 3) -> float:
    """Device ms of one backward of ``out`` (a graph kept across calls)
    into ``inputs`` under ``grad``: CUDA events around ``reps`` backwards
    alone, with the card idle (synchronised) before the start event. The
    backward's own launches outlast its host path, so no sleep is queued
    ahead of it; no forward runs in the window."""
    for _ in range(warmup):
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def product_s(flops: float, dtype) -> float:
    """The least seconds for ``flops`` of matrix products in ``dtype``:
    bf16 at the tensor cores' peak, float32 as 3xTF32 (3 x FLOPs at the
    TF32 peak)."""
    return 3 * flops / PEAK_TF32 if dtype == torch.float32 else flops / PEAK_OPS[dtype]


def attention_flops(kind: str, lengths, h: int = H) -> float:
    """4 (fwd), 6 (dq) or 8 (dkv) x H*D*sum(len^2)."""
    lens = np.asarray(lengths, np.float64)
    return dict(zip(("fwd", "dq", "dkv"), (4, 6, 8)))[kind] * h * D * float((lens**2).sum())


def attention_bound(kind: str, lengths, t: int, dtype, h: int = H):
    """(ms, 'bytes' | 'operations'): the least time for this data. FLOPs
    (``attention_flops``) as ``product_s`` counts them. Bytes: the valid
    rows of each input read once (q, k, v; the backward also dO and the f32
    lse and D), every row of each output written once (o and, in training,
    the f32 lse; dq; dk and dv)."""
    lens = np.asarray(lengths, np.float64)
    flops = attention_flops(kind, lengths, h)
    esz = torch.tensor([], dtype=dtype).element_size()
    valid, rows = lens.sum(), len(lens) * t
    if kind == "fwd":
        nbytes = (3 * valid + rows) * h * D * esz + rows * h * 4
    else:
        nbytes = 4 * valid * h * D * esz + 2 * valid * h * 4 + (rows if kind == "dq" else 2 * rows) * h * D * esz
    t_ops, t_bytes = product_s(flops, dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def attention_inputs(b, t, lengths, dtype, gen, h: int = H):
    """Random q, k, v as the model gives them (strided views of one fused
    projection) and the [B] int32 lengths, on the card."""
    qkv = torch.randn(b, t, 3 * h * D, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.view(b, t, h, D) for x in qkv.split(h * D, dim=-1))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def attention_error(got, want, lens, backward: bool = False, slack=None):
    """Kernel output against the plain version's ([B, T, ...] rows): (max
    abs error on valid rows, the largest share of fa.kernel_tolerance (plus
    the per-element ``slack`` of fa.backward_rounding_slack, for bf16 dk
    and dv) that one element uses, whether every row past the length is
    exactly 0). The check passes at share <= 1."""
    valid = torch.arange(got.shape[1], device=got.device)[None, :] < lens[:, None]
    want_valid = want[valid].float()
    rtol, atol = fa.kernel_tolerance(want[valid], backward)
    limit = atol + rtol * want_valid.abs() + (0.0 if slack is None else slack[valid])
    err = (got[valid].float() - want_valid).abs()
    share = (err / limit).max().item() if err.numel() else 0.0
    return (err.max().item() if err.numel() else 0.0), share, bool(torch.all(got[~valid] == 0))


def lse_error(got, want, lens):
    """(max abs error, share of the LSE limit, zeros past the length) for
    [B, H, T] log-sum-exps."""
    valid = (torch.arange(got.shape[-1], device=got.device)[None, :] < lens[:, None])[:, None, :]
    valid = valid.expand_as(got)
    err = (got[valid] - want[valid]).abs()
    share = (err / (LSE_ATOL + LSE_RTOL * want[valid].abs())).max().item()
    return err.max().item(), share, bool(torch.all(got[~valid] == 0))


def kernel_errors(b, t, lengths, dtype, rate, gen, h: int = H, without_slack: bool = False):
    """The three kernels and their plain versions on one random input:
    ({output: (max abs err, share of its limit, zeros past the length)}
    for o, lse, dq, dk and dv, and with ``without_slack`` also dk and dv
    against kernel_tolerance alone; the inputs; the forward's outputs)."""
    q, k, v, lens = attention_inputs(b, t, lengths, dtype, gen, h)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    return attention_pair_errors(q, k, v, lens, rate, DROPOUT_SEED if rate > 0 else None, do, without_slack)


def attention_pair_errors(q, k, v, lens, rate, seed, do, without_slack: bool = False):
    """``kernel_errors`` on given inputs: the forward (o, lse) and the dq,
    dk/dv pair under the upstream gradient ``do``, each against its plain
    version; ``repeat``: a second launch of the pair bit-equal to the first
    (its share 0, else inf); for float32 inputs ``dq_f64``, ``dk_f64`` and
    ``dv_f64``: (the kernel's ``fa.norm_distance`` from
    ``fa.attention_bwd_float64``, its share of ``ATTN_F64_FACTOR`` times
    the plain version's, True)."""
    o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=True)
    want_o, want_lse = fa.flash_attention_plain(q, k, v, lens, rate, seed, return_lse=True)
    errors = {"o": attention_error(o, want_o, lens), "lse": lse_error(lse, want_lse, lens)}
    args = (q, k, v, do, lse, fa.attention_delta(o, do), lens, rate, seed)
    grads = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    plain = fa.flash_attention_bwd_plain(*args)
    slack = (None, *fa.backward_rounding_slack(*args))
    for grad, got, want, extra in zip(("dq", "dk", "dv"), grads, plain, slack):
        errors[grad] = attention_error(got, want, lens, backward=True, slack=extra)
        if without_slack and grad != "dq":
            errors[f"{grad}_without_slack"] = attention_error(got, want, lens, backward=True)
    again = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    diff = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0 for a, b in zip(again, grads))
    errors["repeat"] = (diff, 0.0 if all(map(torch.equal, again, grads)) else float("inf"), True)
    if q.dtype == torch.float32:
        readings = []
        for grad, got, want, exact in zip(("dq", "dk", "dv"), grads, plain, fa.attention_bwd_float64(*args)):
            got_d, plain_d = fa.norm_distance(got, exact), fa.norm_distance(want, exact)
            limit = ATTN_F64_FACTOR * plain_d
            errors[f"{grad}_f64"] = (got_d, got_d / limit if limit > 0 else (0.0 if got_d == 0 else float("inf")),
                                     True)
            readings.append(f"{grad} {got_d:.3e} (plain {plain_d:.3e})")
        print(f"float64 distance B={q.shape[0]} T={q.shape[1]} H={q.shape[2]} rate {rate}: kernel "
              + ", ".join(readings), flush=True)
    return errors, args, o


def check_kernels(name, b, t, lengths, dtype, rate, gen, h: int = H):
    """The three kernels against their plain versions on one input; one
    row of numbers per kernel."""
    tag = f"{name} {str(dtype).removeprefix('torch.')} rate {rate}"
    errors, args, o = kernel_errors(b, t, lengths, dtype, rate, gen, h)
    for out, (err, share, zeros) in errors.items():
        assert share <= 1 and zeros, f"{tag} {out}: err {err}, {share:.3f} of the limit, zeros past the length {zeros}"
    q, k, v, do, lse, delta, lens, rate, seed = args
    if rate == 0:  # the inference path (no LSE) gives the same output
        assert torch.equal(fa.flash_attention(q, k, v, lens), o), f"{tag}: inference path differs"
    common = {"shape": name, "dtype": str(dtype).removeprefix("torch."), "rate": rate, "B": b, "T": t,
              "H": h}
    return attention_rows(tag, errors, args, common)


def attention_rows(tag, errors, args, common):
    """Kernel, plain, bound and SDPA times of the three kernels on the
    inputs ``args`` (``attention_pair_errors``' second result), beside
    ``errors``; one printed row of numbers per kernel."""
    q, k, v, do, lse, delta, lens, rate, seed = args
    t, h, dtype = q.shape[1], q.shape[2], q.dtype
    lengths = lens.tolist()

    # library yardstick: SDPA with a boolean key mask, forward and backward
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa, 10)
    lib_bwd = backward_ms(sdpa(), (qt, kt, vt), dot, 10)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), 2, warmup=1)
    (err, share, _), (lerr, lshare, _) = errors["o"], errors["lse"]
    dkv = max(errors["dk"][:2], errors["dv"][:2], key=lambda e: e[1])
    rows = {
        "flash_attention_fwd": dict(
            common, max_abs_err=err, limit_share=share, lse_max_abs_err=lerr, lse_limit_share=lshare,
            ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, lens, rate, seed, True), 20),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, lens, rate, seed, True), 2, warmup=1),
            library_ms=lib_fwd),
        "flash_attention_bwd_dq": dict(
            common, max_abs_err=errors["dq"][0], limit_share=errors["dq"][1],
            ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(*args), 20),
            plain_ms=plain_bwd, library_ms=lib_bwd),
        "flash_attention_bwd_dkv": dict(
            common, max_abs_err=dkv[0], limit_share=dkv[1],
            ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args), 20),
            plain_ms=plain_bwd, library_ms=lib_bwd),
    }
    for kernel, kind in zip(rows, ("fwd", "dq", "dkv")):
        rows[kernel]["bound_ms"], rows[kernel]["bound_by"] = attention_bound(kind, lengths, t, dtype, h)
        if dtype == torch.float32:  # the products at the SIMT float32 peak, beside the 3xTF32 bound
            rows[kernel]["simt_ms"] = 1e3 * attention_flops(kind, lengths, h) / PEAK_OPS[torch.float32]
        print("kernel", kernel, json.dumps(rows[kernel]), flush=True)
    pair = rows["flash_attention_bwd_dq"]["ms"] + rows["flash_attention_bwd_dkv"]["ms"]
    print(f"backward pair {tag}: dq + dk/dv {pair:.4f} ms, SDPA backward {lib_bwd:.4f} ms "
          f"({pair / lib_bwd:.2f}x)", flush=True)
    return rows


def conv_inputs(b, t_in, c, k, affine, dtype, gen):
    """One conv layer's random inputs on the card, (x [B, T_in, C], w
    [k, C, C] in ``dtype``, then bias, LN scale and LN bias in float32 or
    None): unit-variance x, weights scaled by (k C)^-1/2."""
    x = torch.randn(b, t_in, c, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, c, c, generator=gen, device="cuda") * (k * c) ** -0.5).to(dtype)
    if not affine:
        return x, w, None, None, None
    return (x, w, torch.randn(c, generator=gen, device="cuda"),
            1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
            torch.randn(c, generator=gen, device="cuda"))


def conv_stack_inputs(cfg, b, dtype, gen):
    """Inputs of conv layers 1-6 of ``cfg`` at the main path's shapes (B
    clips of ``SAMPLES`` samples); bias + LN where the layout has them."""
    c = cfg.conv_dim[0]
    t = (SAMPLES - cfg.conv_kernel[0]) // cfg.conv_stride[0] + 1  # conv_0's frames
    layers = []
    for k in cfg.conv_kernel[1:]:
        layers.append(conv_inputs(b, t, c, k, cfg.feat_extract_norm == "layer", dtype, gen))
        t = (t - k) // 2 + 1
    return layers


def conv_bound(layers):
    """(ms, 'bytes' | 'operations', GFLOP, MB): per layer the larger of
    2 B T_out k C^2 FLOPs as ``product_s`` counts them and x, w, the f32
    bias and LN parameters and y moved once over the memory rate, summed
    over the layers (one launch each)."""
    total, t_ops_all, t_bytes_all, flops_all, bytes_all = 0.0, 0.0, 0.0, 0.0, 0.0
    for x, w, *extra in layers:
        b, t_in, c = x.shape
        k = w.shape[0]
        t_out = (t_in - k) // 2 + 1
        esz = x.element_size()
        flops = 2.0 * b * t_out * k * c * c
        nbytes = esz * (b * t_in * c + k * c * c + b * t_out * c) + 4 * c * sum(e is not None for e in extra)
        t_ops, t_bytes = product_s(flops, x.dtype), nbytes / PEAK_BYTES
        total += max(t_ops, t_bytes)
        t_ops_all, t_bytes_all = t_ops_all + t_ops, t_bytes_all + t_bytes
        flops_all, bytes_all = flops_all + flops, bytes_all + nbytes
    return (1e3 * total, "operations" if t_ops_all > t_bytes_all else "bytes", flops_all / 1e9,
            bytes_all / 1e6)


def conv_library_call(layers):
    """The yardstick, one PyTorch call per step in the port's [B, C, T]
    layout: ``F.conv1d`` (+ ``F.layer_norm`` over channels) + ``F.gelu``
    per layer, parameters in the input's type. Timed only."""
    prepared = [
        (x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous(),
         *(None if e is None else e.to(x.dtype) for e in extra))
        for x, w, *extra in layers
    ]

    def run():
        for xt, wc, bias, scale, shift in prepared:
            y = F.conv1d(xt, wc, bias, stride=2)
            if scale is not None:
                y = F.layer_norm(y.transpose(1, 2), (y.shape[1],), scale, shift, 1e-5)
            F.gelu(y)

    return run


def conv_errors(layers):
    """The conv kernel against its plain version on each layer: (max abs
    error, the largest share of ce.kernel_tolerance one element uses). The
    check passes at share <= 1."""
    worst_err, worst_share = 0.0, 0.0
    for layer in layers:
        got = ce.strided_conv_fused(*layer)
        want = ce.conv_fused_reference(*layer)
        assert got.shape == want.shape
        rtol, atol = ce.kernel_tolerance(want)
        err = (got.float() - want.float()).abs()
        share = (err / (atol + rtol * want.float().abs())).max().item()
        worst_err, worst_share = max(worst_err, err.max().item()), max(worst_share, share)
    return worst_err, worst_share


def check_conv(name, layers) -> dict:
    """The conv kernel against its plain version on each layer of
    ``layers``; one row of numbers for the whole set (times summed over
    the layers)."""
    dtype = layers[0][0].dtype
    worst_err, worst_share = conv_errors(layers)
    assert worst_share <= 1, f"conv {name} {dtype}: err {worst_err}, {worst_share:.3f} of the limit"
    bound_ms, bound_by, gflop, mbytes = conv_bound(layers)
    row = {"shape": name, "dtype": str(dtype).removeprefix("torch."), "B": layers[0][0].shape[0],
           "layers": len(layers), "T_in": [x.shape[1] for x, *_ in layers],
           "bias_ln": layers[0][2] is not None, "gflop": gflop, "mbytes": mbytes,
           "max_abs_err": worst_err, "limit_share": worst_share,
           "ms": cuda_ms(lambda: [ce.strided_conv_fused(*layer) for layer in layers], 10),
           "plain_ms": cuda_ms(lambda: [ce.conv_fused_reference(*layer) for layer in layers], 2,
                               warmup=1),
           "library_ms": cuda_ms(conv_library_call(layers), 10),
           "bound_ms": bound_ms, "bound_by": bound_by}
    if dtype == torch.float32:  # the products at the SIMT float32 peak, beside the 3xTF32 bound
        row["simt_ms"] = 1e3 * gflop * 1e9 / PEAK_OPS[torch.float32]
    print("kernel conv_encoder", json.dumps(row), flush=True)
    return row


def kernel_category(name: str) -> str:
    low = name.lower()
    if "conv_encoder" in low:
        return "conv_encoder (this repo)"
    if "fwd_bf16_kernel" in low or "fwd_f32_kernel" in low:
        return "flash_attention_fwd (this repo)"
    if "dq_bf16_kernel" in low or "dkv_bf16_kernel" in low or "dq_f32_kernel" in low \
            or "dkv_f32_kernel" in low:
        return "flash_attention_bwd (this repo)"
    if "conv" in low or "fprop" in low or "dgrad" in low or "wgrad" in low or "cudnn" in low:
        return "convolution (cuDNN)"
    if any(k in low for k in ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas")):
        return "dense matmul (cuBLAS)"
    if "layer_norm" in low:
        return "layer_norm"
    if "gelu" in low:
        return "gelu"
    if "adam" in low or "foreach" in low or "multi_tensor_apply" in low:
        return "optimizer (foreach)"
    return "other elementwise / reduction"


def profile_breakdown(fn, reps: int = 3, top_ops: int = 0) -> None:
    """Device time per kernel category over ``reps`` calls, and the share
    of the window in which the card ran any kernel (torch.profiler, CUPTI;
    the profiler's own host cost widens the window). With ``top_ops``, also
    the PyTorch ops with the most device time, with their input shapes.
    GPU-side user annotations (``Optimizer.step#Adam.step``) are ranges
    over other kernels, not kernels, and are left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=top_ops > 0) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    )
    assert spans, "the profiler saw no kernel on the card"
    by_cat, by_name, busy, end = {}, {}, 0.0, spans[0][0]
    for start, stop, name in spans:
        cat = kernel_category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + (stop - start)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    total = sum(by_cat.values())
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"profile {cat}: {us / reps / 1e3:.3f} ms/call, {100 * us / total:.1f} %", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile kernel {us / reps / 1e3:.3f} ms/call [{kernel_category(name)}] "
              f"{name[:140]}", flush=True)
    print(f"profile device busy {100 * busy / (end - spans[0][0]):.1f} % of the kernel window, "
          f"{len(spans) // reps} kernels/call", flush=True)
    ops = sorted(prof.key_averages(group_by_input_shape=True),
                 key=lambda a: -a.self_device_time_total)[:top_ops]
    for a in ops:
        print(f"profile op {a.self_device_time_total / reps / 1e3:.3f} ms/call {a.key} "
              f"{str(a.input_shapes)[:200]}", flush=True)


def cosine_scores(embeddings, pairs) -> np.ndarray:
    """The cosine evaluator's scores of ``pairs`` over ``embeddings`` (a
    dict by id), mapped to (s + 1) / 2 and clipped to [0, 1] as predict
    maps them."""
    raw = CosineDistanceEvaluator()._compute_prediction_scores(
        [(EmbeddingSample(a, embeddings[a]), EmbeddingSample(b, embeddings[b])) for a, b in pairs])
    return np.clip((np.asarray(raw) + 1) / 2, 0, 1)


def cosine(a, b) -> np.ndarray:
    return (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-8)


def serving_samples(rng):
    return [
        SpeakerSample(f"utt{i:02d}", rng.normal(0, 0.1, int(s * 16000)).astype(np.float32))
        for i, s in enumerate(UTTERANCE_S)
    ]


def unpadded_embeddings(forward, model, samples):
    return {
        s.key: forward(model, torch.from_numpy(s.wav[None]).cuda()).cpu().numpy()[0]
        for s in samples
    }


def padding_ratio(served, alone) -> float:
    """max_k |served[k] - alone[k]| / min_{i != j} |alone[i] - alone[j]|
    (L2): how far padding moved an embedding, against how far apart two
    utterances' embeddings are in this run."""
    keys = sorted(alone)
    a = np.stack([alone[k] for k in keys])
    moved = np.linalg.norm(np.stack([served[k] for k in keys]) - a, axis=-1).max()
    apart = np.linalg.norm(a[:, None] - a[None], axis=-1)
    return float(moved / apart[~np.eye(len(keys), dtype=bool)].min())


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def reset_launches() -> None:
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd_dq.launches = 0
    fa.flash_attention_bwd_dkv.launches = 0
    ce.strided_conv_fused.launches = 0


def launches() -> dict:
    return {
        "flash_attention_fwd": fa.flash_attention.launches,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches,
        "conv_encoder": ce.strided_conv_fused.launches,
    }


def int8_launches() -> dict:
    """The int8 kernels' counts (apart from ``launches()``, whose dict the
    earlier phases compare whole)."""
    return {"int8_quantize": quant.quantize_rows.launches, "int8_gemm": quant.int8_gemm.launches}


def reset_int8_launches() -> None:
    quant.quantize_rows.launches = 0
    quant.int8_gemm.launches = 0


CTC_WRAPPERS = ("ctc_alpha_beta", "ctc_grad")  # the forward, the backward


def ctc_launches() -> dict:
    """The CTC kernels' counts (apart from ``launches()``, as the int8
    ones)."""
    return {name: getattr(ctc, name).launches for name in CTC_WRAPPERS}


def reset_ctc_launches() -> None:
    for name in CTC_WRAPPERS:
        getattr(ctc, name).launches = 0


def build_phase() -> None:
    t0 = time.perf_counter()
    reports = _build.build_all(KERNEL_SOURCES)
    print(f"build_s {time.perf_counter() - t0:.2f} ({len(reports)} sources in parallel)", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("ptxas", name, line.strip(), flush=True)


def kernel_phase() -> dict:
    """Phase 3; returns the rows of the LARGE training shapes (attention
    B=48, H=16, bf16, rate 0.1; the conv over layers 1-6 at B=48, bf16),
    and under the names of ``KERNELS_F32`` the float32 attention rows at
    BASE's training shape, rate 0.1, and the float32 conv at LARGE's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, b, t, lengths in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for rate in RATES:
                got = check_kernels(name, b, t, lengths, dtype, rate, gen)
                if (name, dtype, rate) == ("train_3s", torch.float32, 0.1):
                    rows.update({f"{kernel}_f32": row for kernel, row in got.items()})
    rows.update(check_kernels("large_train_3s", LARGE_BATCH, 149, [149] * LARGE_BATCH, torch.bfloat16,
                              0.1, gen, h=H_LARGE))
    for dtype in (torch.float32, torch.bfloat16):
        check_conv("ragged_short", [conv_inputs(2, t_in, 512, k, True, dtype, gen)
                                    for t_in, k in CONV_RAGGED])
        check_conv("base_train_3s", conv_stack_inputs(BASE_CONFIG, 66, dtype, gen))
        large = check_conv("large_train_3s", conv_stack_inputs(LARGE_CONFIG, LARGE_BATCH, dtype, gen))
        rows["conv_encoder" if dtype == torch.bfloat16 else "conv_encoder_f32"] = large
    return rows


def serving_phase(card: str) -> None:
    """Phases 4 and 5 (the serving main path and bucketed serving)."""
    forward, (model, example_wav) = entry()
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.normal(0, 0.1, (BATCH, SAMPLES)).astype(np.float32)).cuda()
    reset_launches()
    emb = forward(model, wav)
    torch.cuda.synchronize()
    serve_launches = launches()
    assert serve_launches == {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 0,
                              "flash_attention_bwd_dkv": 0, "conv_encoder": 0}, \
        f"serving launches {serve_launches}"
    assert emb.shape == (BATCH, 768) and emb.dtype == torch.float32
    assert torch.isfinite(emb).all(), "main path: non-finite embeddings"
    assert torch.isfinite(forward(model, example_wav)).all()
    ms = cuda_ms(lambda: forward(model, wav), 10)
    torch.cuda.reset_peak_memory_stats()
    forward(model, wav)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"serving main_path B={BATCH} x {SAMPLES} bf16: {ms:.3f} ms/batch, "
          f"{BATCH / ms * 1e3:.1f} utt/s, peak {peak_gib:.2f} GiB, launches {serve_launches} "
          f"[{card}]", flush=True)
    profile_breakdown(lambda: forward(model, wav))

    # the same weights in float32, card (f32 kernel) vs CPU (plain version)
    model32 = build_model(torch.device("cuda"), torch.float32)
    small = rng.normal(0, 0.1, (3, 32000)).astype(np.float32)
    small_mask = np.arange(32000)[None, :] < np.array([32000, 21000, 9000])[:, None]
    small *= small_mask
    with torch.inference_mode():
        on_card = model32.compute_embedding(
            torch.from_numpy(small).cuda(), torch.from_numpy(small_mask).cuda()
        ).cpu().numpy()
        on_cpu = copy.deepcopy(model32).cpu().compute_embedding(
            torch.from_numpy(small), torch.from_numpy(small_mask)
        ).numpy()
        bf16_vs_f32 = cosine(emb.cpu().numpy(), model32.compute_embedding(wav).cpu().numpy())
    rel = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    print(f"f32 card vs cpu: max abs err / max abs {rel:.3e}; "
          f"bf16 vs f32 embeddings: min cosine {bf16_vs_f32.min():.6f}", flush=True)
    assert rel < F32_REL_TOL, f"f32 card vs cpu differ: {rel}"
    del model32

    samples = serving_samples(rng)
    longest = max(len(s.wav) for s in samples)
    frames = feat_extract_output_lengths(-(-longest // 16000) * 16000)
    extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)
    serve_s = time.perf_counter() - t0
    assert launches()["flash_attention_fwd"] == 12 * 3, f"serving launched {launches()}"
    by_key = {e.sample_id: e.embedding for e in served}
    alone = unpadded_embeddings(forward, model, samples)
    cos = np.array([cosine(by_key[k], alone[k]) for k in alone])
    ratio = padding_ratio(by_key, alone)
    print(f"serving: {len(samples)} utterances, {sum(UTTERANCE_S):.1f} s of audio in "
          f"{serve_s:.4f} s ({sum(UTTERANCE_S) / serve_s:.0f}x real time, warm), "
          f"longest bucket T={frames} frames; bucketed vs unpadded batch-1: "
          f"distance ratio {ratio:.4f} (limit {MAX_PAD_RATIO}), min cosine "
          f"{cos.min():.6f}", flush=True)
    assert ratio <= MAX_PAD_RATIO, f"padding moved an embedding: distance ratio {ratio}"
    keys = sorted(by_key)
    pairs = [tuple(rng.choice(keys, 2, replace=False)) for _ in range(20)]
    scores = cosine_scores(by_key, pairs)
    assert scores.shape == (20,) and np.all((scores >= 0) & (scores <= 1))
    print("scores", " ".join(f"{s:.4f}" for s in scores), flush=True)


WATCHED = ("head.fc_out.weight", "aam.weights", "wav2vec2.encoder.layers.0.attention.qkv_proj.weight",
           "wav2vec2.feature_encoder.conv_0.weight", "wav2vec2.feature_encoder.conv_1.weight")


def train_phase(card: str, make_entry=train_entry, label: str = "train",
                conv_per_step: int = 0, dispatches: int = TRAIN_DISPATCHES, after=None) -> dict:
    """Phases 6, 10 and 40: warm-up, then ``dispatches`` timed dispatches
    of ``make_entry()``'s step; each attention kernel launched once per kept
    layer (the forward twice where the recipe rematerialises its layers:
    the LARGE recipe's ``trainer.remat``) and the conv kernel
    ``conv_per_step`` times in every step; ``after(step, state, batch)``
    runs before the peak-memory step. Returns each kernel's launches over
    the timed steps."""
    step, (state, batch) = make_entry()
    precision = "bf16 autocast" if state.model.cfg.w2v2.dtype == "bfloat16" else "float32"
    fwd_per_layer = 2 if state.model.wav2vec2.encoder.remat else 1
    b = batch["labels"].shape[1]
    steps = batch["labels"].shape[0]
    state, metrics = step(state, batch)  # warm-up dispatch
    torch.cuda.synchronize()
    assert "accuracy" in metrics, f"{label}: no accuracy metric"
    watched = {n: p.detach().clone() for n, p in state.model.named_parameters() if n in WATCHED}
    assert len(watched) >= 4, f"{label}: watched parameters {sorted(watched)}"
    # each step ends in one optimizer update: read the counters there
    counts, update = [], state.apply_gradients
    state.apply_gradients = lambda: (counts.append(launches()), update())
    reset_launches()
    losses, kept, accuracy = [], [], []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(dispatches):
        state, metrics = step(state, batch)
        kept += metrics["layers_run"].tolist()
        losses.append(metrics["loss"])
        accuracy.append(metrics["accuracy"])
    stop.record()
    torch.cuda.synchronize()
    state.apply_gradients = update
    total = launches()
    per_step = [{k: n - (counts[i - 1][k] if i else 0) for k, n in c.items()}
                for i, c in enumerate(counts)]
    for run, got in zip(kept, per_step, strict=True):
        want = {**{k: run for k in ATTENTION}, "flash_attention_fwd": fwd_per_layer * run,
                "conv_encoder": conv_per_step}
        assert got == want, f"{label}: a step kept {run} layers, launched {got}"
    n_steps = dispatches * steps
    ms = start.elapsed_time(stop) / n_steps
    losses = torch.cat(losses).cpu()
    accuracy = torch.cat(accuracy).cpu()
    assert torch.isfinite(losses).all(), f"{label}: non-finite training loss {losses}"
    assert torch.all((accuracy >= 0) & (accuracy <= 1)), f"{label}: accuracy {accuracy}"
    moved = {n: float((p.detach() - watched[n]).abs().max()) for n, p in state.model.named_parameters()
             if n in watched}
    assert all(v > 0 for v in moved.values()), f"{label}: parameters did not move: {moved}"
    print(f"{label} layers kept per step {kept}; launches per step "
          f"{[list(c.values()) for c in per_step]} (fwd, dq, dk/dv, conv); total {total}", flush=True)
    if after is not None:
        after(step, state, batch)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    remat = "on (full recompute)" if fwd_per_layer == 2 else "off"
    print(f"{label} main_path B={b} x {SAMPLES} {precision}, remat {remat}: {ms:.3f} ms/step, "
          f"{b / ms * 1e3:.1f} utt/s, peak {peak_gib:.2f} GiB, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, accuracy {accuracy.tolist()}, max param change {moved} [{card}]",
          flush=True)
    profile_breakdown(lambda: step(state, batch), reps=1, top_ops=8)
    return total


def grads_of(model) -> dict:
    return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}


def worst_grad_error(card_model, cpu_model) -> tuple:
    """(the largest max abs error / max abs gradient over the parameters,
    its parameter's name), card against CPU."""
    g_card, g_cpu = grads_of(card_model), grads_of(cpu_model)
    worst, worst_name = 0.0, ""
    for n, g in g_cpu.items():
        scale = float(g.abs().max())
        err = float((g_card[n] - g).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


def f32_train_phase(cfg=None, label: str = "BASE", conv_launches: int = 0) -> dict:
    """Phases 7 and 11: one float32 step of the recipe ``cfg`` cut to 2
    layers, card against CPU, same weights and step generator seed,
    dropout, layerdrop and SpecAugment on; the card step launches the conv
    kernel ``conv_launches`` times. ``cfg`` None is ``speaker_wav2vec2_ce``.
    Returns the card step's launches."""
    cfg = load_recipe("speaker_wav2vec2_ce") if cfg is None else cfg
    state, task = build_train_state(torch.device("cuda"), "f32", cfg, seed=1, num_layers=2)
    cpu_model = copy.deepcopy(state.model).cpu()
    cpu_state = TrainState.create(cpu_model, build_optimizer(cfg), seed=1)
    cpu_task = SpeakerTask(cpu_model, task.mode)
    rng = np.random.default_rng(5)
    lengths = np.array([32000, 21000, 9000])
    wav = rng.normal(0, 0.1, (3, 32000)).astype(np.float32)
    mask = np.arange(32000)[None, :] < lengths[:, None]
    batch = {"features": torch.from_numpy(wav * mask), "mask": torch.from_numpy(mask),
             "labels": torch.from_numpy(rng.integers(0, 5994, 3))}
    reset_launches()
    _, on_card = make_train_step(task)(state, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    step_launches = launches()
    card_launches = step_launches["conv_encoder"]
    _, on_cpu = make_train_step(cpu_task)(cpu_state, batch)
    loss_rel = abs(float(on_card["loss"]) - float(on_cpu["loss"])) / abs(float(on_cpu["loss"]))
    worst, worst_name = worst_grad_error(state.model, cpu_model)
    print(f"f32 {label} train step card vs cpu (2 layers, dropout on, layers run "
          f"{on_card['layers_run']}/{on_cpu['layers_run']}, conv launches {card_launches}): loss "
          f"{float(on_card['loss']):.6f} vs {float(on_cpu['loss']):.6f} (rel {loss_rel:.3e}); grads "
          f"max err / max abs per parameter {worst:.3e} ({worst_name})", flush=True)
    assert on_card["layers_run"] == on_cpu["layers_run"]
    assert card_launches == conv_launches, f"f32 {label} step: {card_launches} conv launches"
    assert loss_rel < F32_REL_TOL and worst < F32_REL_TOL, f"f32 {label} train step: card vs cpu differ"
    return step_launches


def overfit_losses(lr: float, seed: int = 2) -> list:
    """CE over ``OVERFIT_STEPS`` steps on one fixed batch (full BASE, the
    recipe's regularisation, bf16 autocast) at a constant ``lr``."""
    state, task = build_train_state(torch.device("cuda"), "bf16", seed=seed)
    state.tx = AdamTx(lambda step: lr)
    state.tx.init(state.named_params())
    step = make_train_step(task)
    batch = {k: v[0] for k, v in synthetic_batch(OVERFIT_BATCH, SAMPLES, torch.device("cuda"),
                                                 seed=seed + 1).items()}
    return [float(step(state, batch)[1]["loss"]) for _ in range(OVERFIT_STEPS)]


def overfit_fall(losses) -> float:
    return float(np.mean(losses[:3]) - np.mean(losses[-3:]))


def overfit_phase() -> None:
    losses = overfit_losses(OVERFIT_LR)
    fall = overfit_fall(losses)
    print(f"overfit {OVERFIT_STEPS} steps, B={OVERFIT_BATCH}, lr {OVERFIT_LR}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, fall {fall:.4f} (limit {OVERFIT_MIN_FALL})",
          flush=True)
    assert fall >= OVERFIT_MIN_FALL, f"overfit: the loss fell only {fall}"


@torch.inference_mode()
def embed(model, wav, mask=None) -> torch.Tensor:
    return model.compute_embedding(wav, mask)


def large_serving_phase(card: str) -> None:
    """Phase 9: LARGE + AAM head with the fused conv, serving."""
    dev = torch.device("cuda")
    model = build_model(dev, torch.bfloat16, size="large", conv_impl="fused_pallas", use_aam=True)
    rng = np.random.default_rng(9)
    wav = torch.from_numpy(rng.normal(0, 0.1, (LARGE_BATCH, SAMPLES)).astype(np.float32)).cuda()
    reset_launches()
    emb = embed(model, wav)
    torch.cuda.synchronize()
    got = launches()
    assert got == {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                   "conv_encoder": 6}, f"LARGE serving launches {got}"
    assert emb.shape == (LARGE_BATCH, 1024) and emb.dtype == torch.float32
    assert torch.isfinite(emb).all(), "LARGE serving: non-finite embeddings"
    ms = cuda_ms(lambda: embed(model, wav), 10)
    torch.cuda.reset_peak_memory_stats()
    embed(model, wav)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"large serving main_path B={LARGE_BATCH} x {SAMPLES} bf16 fused conv: {ms:.3f} ms/batch, "
          f"{LARGE_BATCH / ms * 1e3:.1f} utt/s, peak {peak_gib:.2f} GiB, launches {got} [{card}]",
          flush=True)
    profile_breakdown(lambda: embed(model, wav))

    # the same weights through the cuDNN route (bf16) and in float32
    xla = build_model(dev, torch.bfloat16, size="large", conv_impl="xla", use_aam=True)
    xla.load_state_dict(model.state_dict())
    reset_launches()
    emb_xla = embed(xla, wav)
    assert launches()["conv_encoder"] == 0, "the xla route launched the conv kernel"
    del xla
    model32 = build_model(dev, torch.float32, size="large", conv_impl="fused_pallas", use_aam=True)
    emb32 = embed(model32, wav)
    # the bf16 limit of ce.kernel_tolerance: rtol 2e-2, atol 2^-5 x RMS
    atol = ce.BF16_ATOL_RMS * emb_xla.square().mean().sqrt().item()
    share = ((emb - emb_xla).abs() / (atol + ce.BF16_RTOL * emb_xla.abs())).max().item()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    print(f"large routes: fused vs xla bf16 embeddings max err / max abs {rel(emb, emb_xla):.3e}, "
          f"{share:.3f} of the bf16 limit; vs f32: fused {rel(emb, emb32):.3e}, xla "
          f"{rel(emb_xla, emb32):.3e}; min cosine fused vs xla "
          f"{cosine(emb.cpu().numpy(), emb_xla.cpu().numpy()).min():.6f}", flush=True)
    assert share <= 1, f"LARGE: the fused and xla routes differ by {share:.3f} of the bf16 limit"

    # float32, card (f32 conv and attention kernels) vs CPU (plain versions)
    small = rng.normal(0, 0.1, (3, 32000)).astype(np.float32)
    small_mask = np.arange(32000)[None, :] < np.array([32000, 21000, 9000])[:, None]
    small *= small_mask
    on_card = embed(model32, torch.from_numpy(small).cuda(), torch.from_numpy(small_mask).cuda())
    on_cpu = embed(copy.deepcopy(model32).cpu(), torch.from_numpy(small), torch.from_numpy(small_mask))
    rel32 = rel(on_card.cpu(), on_cpu)
    print(f"large f32 card vs cpu: max abs err / max abs {rel32:.3e}", flush=True)
    assert rel32 < F32_REL_TOL, f"LARGE f32 card vs cpu differ: {rel32}"
    del model32

    # padding invariance of bucketed serving
    samples = serving_samples(rng)
    extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)  # warm-up
    reset_launches()
    served = {e.sample_id: e.embedding
              for e in extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)}
    got = launches()
    assert (got["flash_attention_fwd"], got["conv_encoder"]) == (24 * 3, 6 * 3), f"served {got}"
    alone = unpadded_embeddings(embed, model, samples)
    ratio = padding_ratio(served, alone)
    print(f"large serving: {len(samples)} utterances, bucketed vs unpadded batch-1: distance ratio "
          f"{ratio:.4f} (limit {MAX_PAD_RATIO}), min cosine "
          f"{min(cosine(served[k], alone[k]) for k in alone):.6f}", flush=True)
    assert ratio <= MAX_PAD_RATIO, f"LARGE: padding moved an embedding: distance ratio {ratio}"


def write_predict_folder(folder: pathlib.Path, seconds, speakers: int, rng) -> dict:
    """16 kHz WAV files of the given lengths under VoxCeleb-style
    ``idNNNNN/ytX/NNNNN.wav`` paths, speakers in turn, each a speaker's
    tone mix plus noise; returns {id: seconds}."""
    files = {}
    for i, sec in enumerate(seconds):
        spk = i % speakers
        rel = f"id{10000 + spk:05d}/yt{i // speakers % 3}/{i:05d}.wav"
        t = np.arange(int(sec * 16000)) / 16000
        tone = sum(np.sin(2 * np.pi * f * t) for f in (110 + 40 * spk, 230 + 55 * spk))
        wav = 0.05 * tone + rng.normal(0, 0.05, t.shape)
        (folder / rel).parent.mkdir(parents=True, exist_ok=True)
        write_wav(folder / rel, wav.astype(np.float32))
        files[rel] = sec
    return files


def read_scores(path: pathlib.Path):
    lines = [line.split(" ") for line in path.read_text().splitlines()]
    return np.array([float(x[0]) for x in lines]), [(x[1], x[2]) for x in lines]


def record_path_inputs(model) -> tuple:
    """Forward hooks on a fused-conv speaker model that keep, from its
    longest batch, the inputs the kernels get: conv 0's LayerNorm output
    (whose GELU is fused conv 1's input) and the feature encoder's output,
    and each ``PREDICT_ATTN_LAYERS`` layer's fused q/k/v projection and
    lengths. Returns (the record, the hook handles)."""
    rec, lens, handles = {}, {}, []
    enc = model.wav2vec2.feature_encoder

    def keep(name, value, extra=None):
        if name not in rec or value.shape[1] > rec[name][0].shape[1]:
            rec[name] = value.detach(), extra

    handles.append(enc.layer_norm_0.register_forward_hook(lambda m, a, out: keep("ln0", out)))
    handles.append(enc.register_forward_hook(lambda m, a, out: keep("features", out)))
    for i in PREDICT_ATTN_LAYERS:
        attn = model.wav2vec2.encoder.layers[i].attention
        # SelfAttention.forward(x, lengths, ...) runs qkv_proj after this hook
        handles.append(attn.register_forward_pre_hook(lambda m, a, i=i: lens.__setitem__(i, a[1])))
        handles.append(attn.qkv_proj.register_forward_hook(
            lambda m, a, out, i=i: keep(f"qkv{i}", out, lens[i])))
    return rec, handles


def check_path_kernels(model, rec) -> str:
    """The fused conv (layers 1-6) and the attention forward on the inputs
    the longest predict batch gave them, each against its plain version
    under its kernel_tolerance. Conv layer i + 1 takes the kernel's output
    of layer i; the chain's end must equal the feature encoder's output,
    which shows that these were the path's inputs. Returns a report."""
    enc, cfg = model.wav2vec2.feature_encoder, model.wav2vec2.cfg
    x, worst, report = F.gelu(rec["ln0"][0]), (0.0, 0.0), []
    for i in range(1, len(cfg.conv_kernel)):
        conv, ln = getattr(enc, f"conv_{i}"), getattr(enc, f"layer_norm_{i}")
        args = (x.to(getattr(torch, cfg.dtype)), conv.weight.permute(2, 1, 0), conv.bias, ln.weight, ln.bias,
                cfg.layer_norm_eps)
        got, want = ce.strided_conv_fused(*args), ce.conv_fused_reference(*args)
        rtol, atol = ce.kernel_tolerance(want)
        err = (got.float() - want.float()).abs()
        share = (err / (atol + rtol * want.float().abs())).max().item()
        assert share <= 1, f"predict conv_{i} {tuple(args[0].shape)}: {share:.3f} of the limit"
        worst, x = max(worst, (share, err.max().item())), got
    assert torch.equal(x, rec["features"][0]), "predict: the replayed conv chain is not the path's"
    report.append(f"conv 1-{len(cfg.conv_kernel) - 1} from B x T_in {tuple(rec['ln0'][0].shape[:2])} {x.dtype}: max abs err "
                  f"{worst[1]:.3e}, {worst[0]:.3f} of the limit")
    h = cfg.hidden_size
    for i in PREDICT_ATTN_LAYERS:
        qkv, lens = rec[f"qkv{i}"]
        b, t, _ = qkv.shape
        q, k, v = (part.view(b, t, cfg.num_heads, h // cfg.num_heads) for part in qkv.split(h, dim=-1))
        got = fa.flash_attention_fwd(q, k, v, lens)[0]
        err, share, zeros = attention_error(got, fa.flash_attention_plain(q, k, v, lens), lens)
        assert share <= 1 and zeros, f"predict attention layer {i}: {share:.3f} of the limit, zeros {zeros}"
        report.append(f"attention layer {i % cfg.num_layers} B={b} T={t} H={cfg.num_heads} lengths "
                      f"{lens.tolist()} {q.dtype}: max abs err {err:.3e}, {share:.3f} of the limit")
    return "; ".join(report)


def predict_phase(card: str, root: pathlib.Path) -> dict:
    """Phase 12: ``predict.main`` end to end at full LARGE width, its files
    under ``root / "predict"``; returns what phase 34 serves again: the
    overrides, the files, the bf16 scores and the warm utt/s."""
    rng = np.random.default_rng(12)
    tmp = root / "predict"
    tmp.mkdir()
    folder = tmp / "wav"
    seconds = np.round(rng.uniform(2.0, 30.0, PREDICT_FILES), 2)
    files = write_predict_folder(folder, seconds, PREDICT_SPEAKERS, rng)
    by_speaker = {}
    for rel in files:
        by_speaker.setdefault(rel.split("/")[0], []).append(rel.removesuffix(".wav"))
    trials = generate_validation_pairs(by_speaker, PREDICT_TRIALS, seed=12)
    pair_file = tmp / "trials.txt"
    save_evaluation_pairs(trials, pair_file)
    weights = tmp / "large_aam.pt"
    torch.save(build_model(torch.device("cuda"), torch.float32, seed=12, size="large",
                           conv_impl="fused_pallas", use_aam=True).state_dict(), weights)
    overrides = [
        "network=wav2vec2_fc", "network.wav2vec2_size=large", "network.conv_impl=fused_pallas",
        "optim/loss=aam_softmax", "trainer.precision=bf16", f"load_network_from_checkpoint={weights}",
        f"data.dataloader.test_pad_to_multiple={PREDICT_PAD}",
        f"data.dataloader.test_batch_size={PREDICT_BATCH}", ONE_RANK,
        f"predict_folder_path={folder}", f"pair_prediction_path={pair_file}",
    ]
    reset_launches()
    t0 = time.perf_counter()
    score_file = predict.main(overrides)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launches()
    batches = -(-len(files) // PREDICT_BATCH)
    assert got == {"flash_attention_fwd": 24 * batches, "flash_attention_bwd_dq": 0,
                   "flash_attention_bwd_dkv": 0, "conv_encoder": 6 * batches}, f"predict launched {got}"
    scores, pairs = read_scores(score_file)
    assert len(pairs) == len(trials) and np.all(np.isfinite(scores)), "predict: score lines"
    assert np.all((scores >= 0) & (scores <= 1)), f"predict: scores outside [0, 1]: {scores}"

    # the same files through extract_embeddings and the cosine evaluator, called directly
    cfg = load_config(predict.CONFIG_DIR, "predict", overrides)
    model = build_predict_model(cfg)
    samples = [SpeakerSample(rel, normalize_waveform(load_raw_audio(folder / rel))) for rel in files]
    rec, handles = record_path_inputs(model)
    extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH)  # warm-up
    for handle in handles:
        handle.remove()
    kernels_vs_plain = check_path_kernels(model, rec)
    del rec
    warm = []
    for _ in range(PREDICT_TIMED):  # each call ends in a copy of the embeddings to the host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct = {e.sample_id: e.embedding for e in extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH)}
        warm.append(time.perf_counter() - t0)
    del model
    same = float(np.abs(cosine_scores(direct, pairs) - scores).max())
    assert same <= PREDICT_SAME_ATOL, f"predict: written scores differ from the direct ones by {same}"

    # a second run reads the embedding cache and launches nothing
    reset_launches()
    again, _ = read_scores(predict.main(overrides))
    assert sum(launches().values()) == 0 and np.array_equal(again, scores), "predict: cache not reused"

    # the labelled trials' EER and minDCF (random weights: no quality claimed)
    metrics = CosineDistanceEvaluator().evaluate(
        load_evaluation_pairs(pair_file),
        [EmbeddingSample(k.removesuffix(".wav"), v) for k, v in direct.items()])
    assert all(0 <= metrics[k] <= 1 for k in ("eer", "mdc")), f"predict: metrics {metrics}"

    # float32, card against CPU, 4 files of <= 3 s
    f32 = {}
    for dev in ("cuda", "cpu"):
        small = tmp / f"f32_{dev}"
        ids = list(write_predict_folder(small, PREDICT_F32_S, 2, np.random.default_rng(13)))
        small_pairs = small / "pairs.txt"
        small_pairs.write_text("".join(f"{a} {b}\n" for i, a in enumerate(ids) for b in ids[i + 1:]))
        f32[dev], _ = read_scores(predict.main(
            [*overrides[:-2], "trainer.precision=f32", f"predict_folder_path={small}",
             f"pair_prediction_path={small_pairs}"], device=None if dev == "cuda" else "cpu"))
    f32_err = float(np.abs(f32["cuda"] - f32["cpu"]).max())
    assert f32_err <= PREDICT_F32_ATOL, f"predict f32 card vs cpu: {f32_err}"

    audio_s = float(sum(files.values()))
    warm_s = float(np.median(warm))
    print(f"predict kernels vs plain at the longest bucket: {kernels_vs_plain}", flush=True)
    print(f"predict LARGE fused conv bf16: {len(files)} files, {audio_s:.2f} s of audio, "
          f"{len(pairs)} trials, {batches} bucket batches, launches {got}; first call (model build, "
          f"weights, audio, extraction, scoring) {first_s:.3f} s; warm extraction over {len(warm)} runs: "
          f"median {warm_s:.4f} s (min {min(warm):.4f}, max {max(warm):.4f}): {len(files) / warm_s:.2f} utt/s "
          f"({len(files) / max(warm):.2f}-{len(files) / min(warm):.2f}), real-time factor "
          f"{audio_s / warm_s:.1f} ({audio_s / max(warm):.1f}-{audio_s / min(warm):.1f}); written vs direct "
          f"max diff {same:.3e}; cache rerun launches 0; EER {metrics['eer']:.4f}, minDCF "
          f"{metrics['mdc']:.4f} (random weights); f32 card vs cpu max score diff {f32_err:.3e} "
          f"(limit {PREDICT_F32_ATOL}) [{card}]", flush=True)
    return {"overrides": overrides, "folder": folder, "files": files, "scores": scores, "pairs": pairs,
            "batches": batches, "utt_s": len(files) / warm_s, "first_s": first_s, "f32_scores": f32["cuda"]}


def write_run_corpus(root: pathlib.Path, rng, utterances: int = 6) -> tuple:
    """``RUN_SPEAKERS`` x ``utterances`` WAV files of 3.5-5 s under
    ``idNNNNN/ytY/NNNNN.wav`` (``write_predict_folder``'s tones and noise)
    and a trial file of every pair of the last ``RUN_TEST`` speakers'
    utterances; returns (WAV root, trial file, seconds of audio)."""
    wav_dir, seconds = root / "wav", 0.0
    for spk in range(RUN_SPEAKERS):
        t_spk = rng.uniform(3.5, 5.0, utterances)
        for i, sec in enumerate(t_spk):
            rel = f"id{20000 + spk:05d}/yt{i // 2}/{i % 2:05d}.wav"
            t = np.arange(int(sec * 16000)) / 16000
            tone = sum(np.sin(2 * np.pi * f * t) for f in (110 + 9 * spk, 230 + 13 * spk))
            (wav_dir / rel).parent.mkdir(parents=True, exist_ok=True)
            write_wav(wav_dir / rel, (0.05 * tone + rng.normal(0, 0.05, t.shape)).astype(np.float32))
        seconds += float(t_spk.sum())
    test = [f"id{20000 + spk:05d}/yt{i // 2}/{i % 2:05d}.wav"
            for spk in range(RUN_SPEAKERS - RUN_TEST, RUN_SPEAKERS) for i in range(utterances)]
    trials = root / "trials.txt"
    trials.write_text("".join(f"{int(a[:7] == b[:7])} {a} {b}\n" for i, a in enumerate(test) for b in test[i + 1:]))
    return wav_dir, trials, seconds


def device_busy(prof) -> tuple:
    """(share of the kernel window in which the card ran some kernel, the
    window in ms, kernels, {kernel category: device ms}, (name, device ms)
    of the kernel with the most time) of a torch.profiler run."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    assert spans, "the profiler saw no kernel on the card"
    busy, end, by_cat, by_name = 0.0, spans[0][0], {}, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_cat[kernel_category(name)] = by_cat.get(kernel_category(name), 0.0) + (stop - start) / 1e3
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
    return (busy / (end - spans[0][0]), (end - spans[0][0]) / 1e3, len(spans), by_cat,
            max(by_name.items(), key=lambda kv: kv[1]))


def top_ops(prof, n: int) -> tuple:
    """(the ``n`` ops with the most self device ms, the ``n`` with the most
    device memory allocated in them and not freed there) of a torch.profiler
    run with shapes and memory recorded, each as (op, input shapes, ms,
    GiB)."""
    rows = [(a.key, str(a.input_shapes)[:120], a.self_device_time_total / 1e3,
             getattr(a, "self_device_memory_usage", 0) / 2**30)
            for a in prof.key_averages(group_by_input_shape=True)]
    return sorted(rows, key=lambda r: -r[2])[:n], sorted(rows, key=lambda r: -r[3])[:n]


def per_step_categories(by_cat, top_name, top_ms, steps) -> str:
    """``device_busy``'s device ms by kernel category and its largest
    kernel, per step of a profiled window of ``steps`` steps."""
    cats = ", ".join(f"{cat} {ms / steps:.2f}" for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]))
    return f"device ms per step by category: {cats}; the largest kernel {top_ms / steps:.2f} ms/step {top_name[:100]}"


class RunProbe:
    """Instruments the run twin's main path for the length of a ``with``
    block by wrapping methods of the port's public classes: a CUDA event,
    the launch counts and the batch's labels where each training step
    starts (``task_cls.loss_fn``) and a CUDA event and the launch counts
    where it ends (``TrainState.apply_gradients``), every logged step and
    evaluation (``MetricsLogger``), the time of ``prepare_data`` and the
    host's wait for each train batch (the ``Prefetcher`` behind
    ``train_batches``); for ``PairedSpeakerTask`` also every
    ``score_fn`` call's batch, scores and launches, with the number of
    evaluations logged before it. Each step of a batch with ``features``
    also records its (rows, samples, valid samples). The first step keeps its task and registers forward
    hooks on its model, which keep layer ``RUN_ATTN_LAYER``'s q/k/v,
    heads, lengths and dropout seed from the first training forward; with
    ``longest``, from the training forward with the largest T instead, and
    in ``eval_attn`` those of the evaluation forward with the largest T. With
    ``profile=(first, last)``, steps ``first``-``last`` of the run (counted
    from 0) run under torch.profiler. ``dm_cls`` is the data module whose
    ``prepare_data`` and ``train_batches`` are timed. With ``memory``, each
    step records the memory allocated at its start and after its forward
    and its own peak (the peak counter is reset where each step starts;
    ``peak_gib`` gives the largest over the run), and the profiled steps
    also keep the ``TOP_OPS`` ops with the most device time and those with
    the most device memory allocated in them and not freed there."""

    def __init__(self, profile=None, task_cls=SpeakerTask, longest: bool = False, dm_cls=None,
                 memory: bool = False):
        self.profile, self.task_cls, self.longest, self.dm_cls = profile, task_cls, longest, dm_cls
        self.memory, self.ops = memory, None
        self.mem = []  # with memory: per step (bytes at its start, after its forward, its peak)
        self._peak_before = []  # with memory: the peak counter where each step starts, before its reset
        self.starts, self.ends, self.steps, self.evals, self.waits = [], [], [], [], []
        self.labels, self.scored, self.shapes, self.epochs = [], [], [], []
        self.prepare_s, self.busy, self.attn, self.eval_attn, self.task = None, None, None, None, None
        self._saved, self._prof, self._handles = [], None, []

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def _hook_attention(self, model) -> None:
        encoder = getattr(getattr(model, "wav2vec2", model), "encoder", None)
        if not hasattr(encoder, "layers"):  # the conv stack alone, wav2vec v1: no attention to hook
            return
        attn = encoder.layers[RUN_ATTN_LAYER].attention
        seen = {}

        def pre(module, args):  # SelfAttention.forward(x, lengths, seed): seed None = no dropout
            seen.clear()
            if torch.is_grad_enabled():
                seed = args[2] if len(args) > 2 else None
                seen.update(lengths=args[1], seed=seed, rate=0.0 if seed is None else module.dropout,
                            heads=module.num_heads, key="attn")
            elif self.longest:
                seen.update(lengths=args[1], seed=None, rate=0.0, heads=module.num_heads, key="eval_attn")

        def post(module, args, out):
            if not seen:
                return
            key = seen.pop("key")
            kept = getattr(self, key)
            if kept is None or (self.longest and out.shape[1] > kept["qkv"].shape[1]):
                setattr(self, key, {**seen, "qkv": out.detach().clone()})
            if not self.longest:
                for handle in self._handles:
                    handle.remove()

        self._handles = [attn.register_forward_pre_hook(pre), attn.qkv_proj.register_forward_hook(post)]

    def _step_start(self, task, batch) -> None:
        if not self.starts:
            self.task = task
            self._hook_attention(task.model)
        if self.profile and len(self.starts) == self.profile[0]:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                 record_shapes=self.memory, profile_memory=self.memory)
            self._prof.start()
        if self.memory:
            self._peak_before.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            self.mem.append([torch.cuda.memory_allocated()])
        self.labels.append(batch["labels"])
        if "features" in batch:  # not a paired batch
            mask = batch.get("mask")
            self.shapes.append((*batch["features"].shape[:2], None if mask is None else int(mask.sum())))
        self.starts.append((self._event(), launches()))

    def _after_forward(self) -> None:
        if self.memory:
            self.mem[-1].append(torch.cuda.memory_allocated())

    def _step_end(self) -> None:
        self.ends.append((self._event(), launches()))
        if self.memory:
            self.mem[-1].append(torch.cuda.max_memory_allocated())
        if self._prof is not None and len(self.ends) == self.profile[1] + 1:
            torch.cuda.synchronize()
            self._prof.stop()
            self.busy = device_busy(self._prof)
            if self.memory:
                self.ops = top_ops(self._prof, TOP_OPS)
            self._prof = None

    def peak_gib(self, held: int) -> float:
        """With ``memory``: the largest memory allocated over the run so
        far, above ``held`` bytes, in GiB."""
        return (max([*self._peak_before, *(m[-1] for m in self.mem), torch.cuda.max_memory_allocated()])
                - held) / 2**30

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __enter__(self):
        from w2v2_speaker_tpu_torch.data.datamodule import VoxCelebDataModule
        from w2v2_speaker_tpu_torch.runtime.logging import MetricsLogger

        dm_cls = self.dm_cls or VoxCelebDataModule

        probe = self
        self._wrap(self.task_cls, "loss_fn", lambda orig: lambda task, batch, *a, **kw: (
            probe._step_start(task, batch), orig(task, batch, *a, **kw), probe._after_forward())[1])

        def recorded_scores(orig):
            def score_fn(task, batch):
                before = launches()
                scores = orig(task, batch)
                probe.scored.append((len(probe.evals), batch, scores,
                                     {k: n - before[k] for k, n in launches().items()}))
                return scores
            return score_fn

        if self.task_cls is PairedSpeakerTask:
            self._wrap(PairedSpeakerTask, "score_fn", recorded_scores)
        self._wrap(TrainState, "apply_gradients", lambda orig: lambda state: (
            orig(state), probe._step_end())[0])
        self._wrap(MetricsLogger, "log_step", lambda orig: lambda lg, step, m: (
            probe.steps.append((step, dict(m))), orig(lg, step, m))[1])
        self._wrap(MetricsLogger, "log_eval", lambda orig: lambda lg, step, m, split="val": (
            probe.evals.append((step, dict(m))), orig(lg, step, m, split))[1])

        def timed_prepare(orig):
            def run(dm):
                t0 = time.perf_counter()
                orig(dm)
                probe.prepare_s = time.perf_counter() - t0
            return run

        class TimedBatches:
            """The data module's batches, iterable again as its own are
            (the LR range test starts them over), each wait recorded."""

            def __init__(self, source, epoch):
                self.source, self.epoch = source, epoch

            def __iter__(self):
                probe.epochs.append(self.epoch)
                it = iter(self.source)
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    if batch is None:
                        return
                    probe.waits.append(time.perf_counter() - t0)
                    yield batch

        def timed_batches(orig):
            def batches(dm, *a, **kw):
                return TimedBatches(orig(dm, *a, **kw), kw.get("epoch", 0))
            return batches

        self._wrap(dm_cls, "prepare_data", timed_prepare)
        self._wrap(dm_cls, "train_batches", timed_batches)
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.stop()
        for handle in self._handles:
            handle.remove()
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)

    def per_step(self) -> list:
        """(step, layers kept (None for a model without an encoder), launches
        in the step) of every training step."""
        assert len(self.starts) == len(self.ends) == len(self.steps), "unpaired step events"
        return [(step, None if "layers_run" not in m else int(m["layers_run"]),
                 {k: end[1][k] - start[1][k] for k in end[1]})
                for (step, m), start, end in zip(self.steps, self.starts, self.ends)]

    def step_ms(self, first: int, last: int) -> float:
        """Device ms per step from the start of step ``first`` to the end of
        step ``last`` (steps of this run, counted from its first)."""
        torch.cuda.synchronize()
        return self.starts[first][0].elapsed_time(self.ends[last][0]) / (last - first + 1)

    def spans_ms(self, first: int, last: int) -> list:
        """Device ms of each step ``first``-``last``, from its start to its
        end: without the gaps between dispatches."""
        torch.cuda.synchronize()
        return [s[0].elapsed_time(e[0]) for s, e in zip(self.starts[first:last + 1], self.ends[first:last + 1])]


def check_run_attention(rec) -> tuple:
    """Layer ``RUN_ATTN_LAYER``'s training q/k/v, lengths, rate and seed
    through the forward and the dq + dk/dv pair (a random upstream
    gradient), each against its plain version: (summary, errors, the
    kernels' inputs)."""
    qkv, heads = rec["qkv"], rec["heads"]
    b, t, three_hidden = qkv.shape
    hidden = three_hidden // 3
    q, k, v = (part.view(b, t, heads, hidden // heads) for part in qkv.split(hidden, dim=-1))
    lens = rec["lengths"]
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda") if lens is None else lens
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(13), device="cuda").to(q.dtype)
    errors, args, _ = attention_pair_errors(q, k, v, lens, rec["rate"], rec["seed"], do)
    for out, (err, share, zeros) in errors.items():
        assert share <= 1 and zeros, f"run attention {out}: err {err}, {share:.3f} of the limit"
    return (f"layer {RUN_ATTN_LAYER} B={b} T={t} {q.dtype} rate {rec['rate']} seed {rec['seed']}: "
            + ", ".join(f"{out} {share:.3f}" for out, (_, share, _) in errors.items()) + " of the limits",
            errors, args)


def run_phase(card: str, tmp: pathlib.Path) -> tuple:
    """Phase 13: ``w2v2_speaker_tpu_torch.run.main`` end to end at full
    BASE width, then resumed, on a corpus it writes under ``tmp``; returns
    (WAV root, trial file, its shards directory)."""
    from w2v2_speaker_tpu_torch import run

    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    wav_dir, trials, audio_s = write_run_corpus(tmp, rng)
    write_s = time.perf_counter() - t0
    argv = [
        "+experiment=speaker_wav2vec2_ce", f"data.module.data_dir={wav_dir}",
        f"data.module.shards_dir={tmp / 'shards'}", f"data.module.test_trial_path={trials}",
        "data.module.train_val_split_mode=different", f"+data.module.num_val_speakers={RUN_VAL}",
        f"data.shards.samples_per_shard={RUN_SHARD}", f"trainer.max_steps={RUN_STEPS}",
        f"trainer.val_check_interval={RUN_VAL_EVERY}", f"trainer.checkpoint_dir={tmp / 'ckpt'}",
        f"trainer.log_dir={tmp / 'tb'}", "trainer.log_every=1", "seed=13", ONE_RANK,
    ]
    gc.collect()  # what earlier phases left to the collector and the cache
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with RunProbe() as first:
        t0 = time.perf_counter()
        objective = run.main(argv)
        first_s = time.perf_counter() - t0
    index = json.loads((tmp / "ckpt" / "index.json").read_text())
    assert index["last"]["step"] == RUN_STEPS and index["best"], f"run: index {index}"
    with RunProbe(profile=(0, RUN_VAL_EVERY - 1)) as resumed:
        t0 = time.perf_counter()
        objective_2 = run.main([*argv, "trainer.resume=true", f"trainer.max_steps={RUN_RESUMED_STEPS}"])
        resumed_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    index_2 = json.loads((tmp / "ckpt" / "index.json").read_text())
    tb = [f.stat().st_size for f in (tmp / "tb").glob("events.out.tfevents.*")]
    for name, obj in (("run", objective), ("resumed run", objective_2)):
        assert obj is not None and np.isfinite(obj) and 0 <= obj <= 1, f"{name}: objective {obj}"
    assert index_2["last"]["step"] == RUN_RESUMED_STEPS and index_2["best"], f"resumed run: index {index_2}"
    assert tb and all(size > 0 for size in tb), f"run: TensorBoard event files of sizes {tb}"
    assert [s for s, _ in first.steps] == list(range(1, RUN_STEPS + 1)), f"run: steps {first.steps}"
    assert [s for s, _ in resumed.steps] == list(range(RUN_STEPS + 1, RUN_RESUMED_STEPS + 1)), \
        f"resumed run: steps {[s for s, _ in resumed.steps]}"
    kept = []
    for probe in (first, resumed):
        for step, layers, got in probe.per_step():
            want = {**{k: layers for k in ATTENTION}, "conv_encoder": 0}
            assert got == want, f"run step {step}: kept {layers} layers, launched {got}"
            kept.append(layers)
        assert all(np.isfinite(m["loss"]) for _, m in probe.steps), "run: non-finite loss"
    assert first.attn is not None, "run: no training forward reached the hooked layer"
    attention, _, _ = check_run_attention(first.attn)
    val = [m for _, m in first.evals + resumed.evals if "val_eer" in m]
    test = [m for _, m in first.evals + resumed.evals if "test_eer" in m]
    assert len(val) == 3 and len(test) == 2, f"run: evaluations {first.evals + resumed.evals}"
    waits_ms = [1e3 * w for w in first.waits]
    steady = first.step_ms(RUN_VAL_EVERY, RUN_STEPS - 1)
    spans = first.spans_ms(RUN_VAL_EVERY, RUN_STEPS - 1)
    busy, window_ms, kernels, by_cat, (top_name, top_ms) = resumed.busy
    MEASURED["run_ms"] = steady
    print(f"run kernels vs plain on a training batch: {attention}", flush=True)
    print(f"run BASE bf16 B=66 x 48000: {RUN_SPEAKERS} speakers, {audio_s:.1f} s of audio written in "
          f"{write_s:.2f} s; shard preparation {first.prepare_s:.3f} s; steady {steady:.3f} ms/step "
          f"(CUDA events, start of step {RUN_VAL_EVERY + 1} to end of step {RUN_STEPS}; each step's own "
          f"span {[round(x, 2) for x in spans]}, mean {np.mean(spans):.3f}); host wait on the Prefetcher per step: "
          f"mean {np.mean(waits_ms):.2f} ms, by step {[round(w, 2) for w in waits_ms]}; device busy "
          f"{100 * busy:.1f} % of one profiled {RUN_VAL_EVERY}-step dispatch ({window_ms:.1f} ms, {kernels} "
          f"kernels; {per_step_categories(by_cat, top_name, top_ms, RUN_VAL_EVERY)}); validation s {[round(m['val_seconds'], 3) for m in val]}, test s "
          f"{[round(m['test_seconds'], 3) for m in test]}; val EER {[round(m['val_eer'], 4) for m in val]}; "
          f"objectives {objective:.4f}, {objective_2:.4f}; whole run {first_s:.2f} s, resumed "
          f"{resumed_s:.2f} s; layers kept {kept}; peak {peak_gib:.2f} GiB above the {held / 2**30:.2f} GiB "
          f"held at the phase's start [{card}]", flush=True)
    return wav_dir, trials, tmp / "shards"


# trainer.num_devices defaults to every visible card: the run phases drive
# one rank in this process (their probes and launch counts read it)
ONE_RANK = "trainer.num_devices=1"


def corpus_args(wav_dir, trials, shards, ckpt) -> list:
    """The run twin's data and output overrides for phase 13's corpus, on
    one rank."""
    return [
        f"data.module.data_dir={wav_dir}", f"data.module.shards_dir={shards}", f"data.module.test_trial_path={trials}",
        "data.module.train_val_split_mode=different", f"+data.module.num_val_speakers={RUN_VAL}",
        f"trainer.checkpoint_dir={ckpt}", "trainer.log_dir=null", "trainer.log_every=1", ONE_RANK,
    ]


def check_steps(label, probe, last, first: int = 1) -> list:
    """Steps ``first``-``last`` logged with finite losses, each launching
    the forward, dq and dk/dv once per kept layer and no conv; the layers
    kept."""
    assert [s for s, _ in probe.steps] == list(range(first, last + 1)), f"{label}: steps {probe.steps}"
    assert all(np.isfinite(m["loss"]) for _, m in probe.steps), f"{label}: non-finite loss"
    kept = []
    for step, layers, got in probe.per_step():
        assert got == {**{k: layers for k in ATTENTION}, "conv_encoder": 0}, \
            f"{label} step {step}: kept {layers} layers, launched {got}"
        kept.append(layers)
    return kept


def paired_f32_errors() -> dict:
    """The paired network in float32 at full BASE width (the pairs recipe,
    seeded weights), card against CPU from the same weights, on a pair
    batch whose sides are padded each on its own (``PAIRS_F32_SIDES``):
    max abs err / max abs of the logits and of the CLS outputs."""
    dev = torch.device("cuda")
    with torch.device("meta"):
        task, _ = build_model_and_task(load_recipe("speaker_wav2vec2_pairs", ["trainer.precision=f32"]), 0)
    model = task.model.to_empty(device=dev)
    init_parameters(model, torch.Generator(device=dev).manual_seed(14))
    model.eval().requires_grad_(False)
    rng = np.random.default_rng(14)
    batch = collate_paired_batch([
        PairedSample(f"a{i}", rng.normal(0, 0.1, na).astype(np.float32),
                     f"b{i}", rng.normal(0, 0.1, nb).astype(np.float32), i % 2)
        for i, (na, nb) in enumerate(PAIRS_F32_SIDES)])
    assert "mask_a" in batch and "mask_b" in batch, "paired f32: a side is not padded"

    @torch.inference_mode()
    def outputs(m, device):
        t = {k: torch.from_numpy(v).to(device) for k, v in batch.items() if k != "keys"}
        out = m(t["features_a"], t["features_b"], t.get("mask_a"), t.get("mask_b"))
        return {"logit": out["logit"].cpu(), "cls": out["cls_embedding"].cpu()}

    reset_launches()
    on_card = outputs(model, dev)
    assert launches()["flash_attention_fwd"] == model.cfg.w2v2.num_layers, f"paired f32 launched {launches()}"
    on_cpu = outputs(copy.deepcopy(model).cpu(), "cpu")
    return {k: float((on_card[k] - on_cpu[k]).abs().max() / on_cpu[k].abs().max()) for k in on_card}


def pairs_phase(card: str, tmp: pathlib.Path, wav_dir, trials) -> None:
    """Phase 14: ``w2v2_speaker_tpu_torch.run.main`` on the w2v2-bce recipe
    (``speaker_wav2vec2_pairs``) at full BASE width on phase 13's corpus."""
    from w2v2_speaker_tpu_torch import run

    argv = ["+experiment=speaker_wav2vec2_pairs", f"data.shards.samples_per_shard={PAIRS_SHARD}",
            f"trainer.max_steps={PAIRS_STEPS}", f"trainer.val_check_interval={PAIRS_VAL_EVERY}", "seed=14",
            *corpus_args(wav_dir, trials, tmp / "pair_shards", tmp / "pair_ckpt")]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with RunProbe(profile=(1, PAIRS_VAL_EVERY - 1), task_cls=PairedSpeakerTask) as probe:
        t0 = time.perf_counter()
        objective = run.main(argv)
        run_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    index = json.loads((tmp / "pair_ckpt" / "index.json").read_text())
    assert objective is not None and np.isfinite(objective) and 0 <= objective <= 1, f"pairs: objective {objective}"
    assert index["last"]["step"] == PAIRS_STEPS and index["best"], f"pairs: index {index}"
    kept = check_steps("pairs", probe, PAIRS_STEPS)
    positives = [(int(lab.numel()), int(lab.sum())) for lab in probe.labels]
    assert positives == [(PAIRS_BATCH, PAIRS_BATCH // 2)] * PAIRS_STEPS, f"pairs: (rows, positives) {positives}"

    # layer 0's q/k/v of the first training batch: the kernels against their
    # plain versions, then their times at that shape
    attention, errors, args = check_run_attention(probe.attn)
    q = args[0]
    assert q.shape[1] == 3 + 2 * feat_extract_output_lengths(SAMPLES), f"pairs: packed T {q.shape[1]}"
    attention_rows("paired train", errors, args, {"shape": "paired_train_3s", "dtype": "bfloat16",
                                                   "rate": args[7], "B": q.shape[0], "T": q.shape[1],
                                                   "H": q.shape[2]})

    # the test phase's scores against score_fn called on the same batches
    n_test = next(i for i, (_, m) in enumerate(probe.evals) if "test_eer" in m)
    calls = [(batch, scores) for n, batch, scores, _ in probe.scored if n == n_test]
    per_call = [got for n, _, _, got in probe.scored if n == n_test]
    want = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0, "conv_encoder": 0}
    assert all(got == want for got in per_call), f"pairs: test calls launched {per_call}"
    same = max(float((probe.task.score_fn(batch) - scores).abs().max()) for batch, scores in calls)
    n_trials = sum(len(scores) for _, scores in calls)
    assert n_trials == len(trials.read_text().splitlines()), f"pairs: {n_trials} test scores"
    assert same <= PAIRS_SAME_ATOL, f"pairs: test scores vs score_fn differ by {same}"
    longest = max(3 + feat_extract_output_lengths(b["features_a"].shape[1])
                  + feat_extract_output_lengths(b["features_b"].shape[1]) for b, _ in calls)

    steady = probe.step_ms(PAIRS_VAL_EVERY, PAIRS_STEPS - 1)
    spans = probe.spans_ms(PAIRS_VAL_EVERY, PAIRS_STEPS - 1)
    busy, window_ms, kernels, by_cat, (top_name, top_ms) = probe.busy
    waits_ms = [1e3 * w for w in probe.waits]
    val = [m for _, m in probe.evals if "val_eer" in m]
    sanity = [m for _, m in probe.evals if "sanity_val_eer" in m]
    test = probe.evals[n_test][1]
    f32 = paired_f32_errors()
    print(f"pairs kernels vs plain on a paired training batch: {attention}", flush=True)
    print(f"pairs BASE bf16 B={PAIRS_BATCH} x 2 x {SAMPLES} (packed T={q.shape[1]}): shard preparation "
          f"{probe.prepare_s:.3f} s; steady {steady:.3f} ms/step (CUDA events, start of step "
          f"{PAIRS_VAL_EVERY + 1} to end of step {PAIRS_STEPS}; each step's own span "
          f"{[round(x, 2) for x in spans]}, mean {np.mean(spans):.3f}); host wait on the "
          f"Prefetcher per step: mean {np.mean(waits_ms):.2f} ms, by step {[round(w, 2) for w in waits_ms]}; "
          f"device busy {100 * busy:.1f} % of steps 2-{PAIRS_VAL_EVERY} ({window_ms:.1f} ms, {kernels} kernels; "
          f"{per_step_categories(by_cat, top_name, top_ms, PAIRS_VAL_EVERY - 1)}); "
          f"sanity s {[round(m['sanity_seconds'], 3) for m in sanity]}, validation s "
          f"{[round(m['val_seconds'], 3) for m in val]}, test {test['test_seconds']:.3f} s over {n_trials} "
          f"trial pairs in {len(calls)} calls of 12 forward launches each (longest packed T={longest}); test "
          f"scores vs score_fn max diff {same:.3e}; val EER "
          f"{[round(m['val_eer'], 4) for m in val]}; objective {objective:.4f}; whole run {run_s:.2f} s; layers "
          f"kept {kept}; positives per step {[p for _, p in positives]}; peak {peak_gib:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held at the phase's start [{card}]", flush=True)
    print(f"pairs f32 BASE card vs cpu on a padded pair batch {PAIRS_F32_SIDES}, max abs err / max abs "
          f"(limit {F32_REL_TOL}): {json.dumps(f32)} [{card}]", flush=True)
    assert all(v < F32_REL_TOL for v in f32.values()), f"pairs: f32 card vs cpu differ: {f32}"


def pooling_model(dtype: torch.dtype, name: str) -> Wav2Vec2SpeakerModel:
    """wav2vec2-BASE + ``name`` pooling + FC head for serving, eval mode,
    weights seeded 15, the backbone's cast to ``dtype``."""
    dev = torch.device("cuda")
    cfg = Wav2Vec2SpeakerConfig(
        w2v2=Wav2Vec2Config(**{**BASE_CONFIG.__dict__, "dtype": str(dtype).removeprefix("torch."),
                               "layerdrop": 0.0}),
        stat_pooling_type=name)
    with torch.device("meta"):
        model = Wav2Vec2SpeakerModel(cfg, num_speakers=NUM_SPEAKERS)
    model.to_empty(device=dev)
    init_parameters(model, torch.Generator(device=dev).manual_seed(15))
    model.wav2vec2.to(dtype)
    return model.eval().requires_grad_(False)


def bn_stats(state_pt: pathlib.Path) -> dict:
    """The attentive pooling's running statistics in a checkpoint."""
    model = torch.load(state_pt, map_location="cpu")["model"]
    return {k: model[f"stat_pooling.attn_bn.{k}"] for k in ("running_mean", "running_var")}


def pooling_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 15: the pooling zoo at full BASE width (f32 card vs CPU,
    padding invariance of bf16 serving), then ``run.main`` with
    ``attentive`` pooling (two runs, the second resumed, with the best
    checkpoint before the last) and ``first+cls`` on phase 13's shards."""
    from w2v2_speaker_tpu_torch import run

    rng = np.random.default_rng(15)
    small = rng.normal(0, 0.1, (3, 32000)).astype(np.float32)
    small_mask = np.arange(32000)[None, :] < np.array([32000, 21000, 9000])[:, None]
    small *= small_mask
    f32 = {}
    for name in POOLINGS:
        model = pooling_model(torch.float32, name)
        on_card = embed(model, torch.from_numpy(small).cuda(), torch.from_numpy(small_mask).cuda()).cpu()
        on_cpu = embed(copy.deepcopy(model).cpu(), torch.from_numpy(small), torch.from_numpy(small_mask))
        f32[name] = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
        del model
    print(f"pooling f32 card vs cpu, max abs err / max abs: {json.dumps(f32)}", flush=True)
    assert all(v < F32_REL_TOL for v in f32.values()), f"pooling: f32 card vs cpu differ: {f32}"
    ratios = {}
    samples = serving_samples(rng)
    for name in POOL_PADDING:
        model = pooling_model(torch.bfloat16, name)
        extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)  # warm-up
        reset_launches()
        served = {e.sample_id: e.embedding
                  for e in extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)}
        assert launches()["flash_attention_fwd"] == 12 * 3, f"{name} serving launched {launches()}"
        ratios[name] = padding_ratio(served, unpadded_embeddings(embed, model, samples))
        del model
    print(f"pooling bf16 bucketed vs unpadded batch-1 distance ratio (limit {MAX_PAD_RATIO}): "
          f"{json.dumps(ratios)} [{card}]", flush=True)
    assert all(v <= MAX_PAD_RATIO for v in ratios.values()), f"pooling: padding moved an embedding: {ratios}"

    for name in ("attentive", "first+cls"):
        ckpt = tmp / f"{name}_ckpt"
        argv = ["+experiment=speaker_wav2vec2_ce", f"network.stat_pooling_type={name}",
                f"data.shards.samples_per_shard={RUN_SHARD}", f"trainer.val_check_interval={POOL_VAL_EVERY}",
                "seed=15", *corpus_args(wav_dir, trials, shards, ckpt)]
        # attentive: steps 1-2 without a test, their best entry pinned below
        # any EER, then steps 3-4 resumed: the best is step 2 and last step 4
        # by construction, so the test phase's restore has to load step 2
        legs = ([(1, POOL_VAL_EVERY, ["eval_model=false"]), (POOL_VAL_EVERY + 1, POOL_STEPS, ["trainer.resume=true"])]
                if name == "attentive" else [(1, POOL_STEPS, [])])
        reset_launches()
        kept, run_s = [], 0.0
        for first, last, extra in legs:
            if first > 1:
                index = json.loads((ckpt / "index.json").read_text())
                assert [e["step"] for e in index["best"]] == [first - 1], f"{name}: first leg's index {index}"
                index["best"][0]["metric"] = -1.0
                (ckpt / "index.json").write_text(json.dumps(index))
            with RunProbe() as probe:
                t0 = time.perf_counter()
                objective = run.main([*argv, f"trainer.max_steps={last}", *extra])
                run_s += time.perf_counter() - t0
            kept += check_steps(name, probe, last, first)
        assert objective is not None and np.isfinite(objective) and 0 <= objective <= 1, f"{name}: {objective}"
        t = probe.attn["qkv"].shape[1]
        note = f"attention T={t}"
        if name == "first+cls":
            assert t == feat_extract_output_lengths(SAMPLES) + 1, f"first+cls: attention T {t}"
        else:
            index = json.loads((ckpt / "index.json").read_text())
            assert index["best"][0]["step"] == POOL_VAL_EVERY and index["last"]["step"] == POOL_STEPS, \
                f"attentive: index {index}"
            bn = probe.task.model.stat_pooling.attn_bn
            best = bn_stats(ckpt / index["best"][0]["name"] / "state.pt")
            last_stats = bn_stats(ckpt / "last" / "state.pt")
            live = {k: getattr(bn, k).cpu() for k in ("running_mean", "running_var")}
            moved = (float(best["running_mean"].abs().max()), float((best["running_var"] - 1).abs().max()))
            apart = {k: float((best[k] - last_stats[k]).abs().max()) for k in best}
            assert min(moved) > 0, f"attentive: running statistics did not move by step {POOL_VAL_EVERY}: {moved}"
            assert min(apart.values()) > 0, f"attentive: steps 3-4 left the running statistics as they were: {apart}"
            assert all(torch.equal(v, best[k]) for k, v in live.items()), \
                "attentive: the running statistics after the test phase are not the best checkpoint's"
            note += (f"; running mean / var at the best checkpoint (step {POOL_VAL_EVERY}) moved from their "
                     f"initial values by up to {moved[0]:.4f} / {moved[1]:.4f} and differ from last's (step "
                     f"{POOL_STEPS}) by up to {apart['running_mean']:.4f} / {apart['running_var']:.4f}; the "
                     f"model tested holds the best's exactly")
        print(f"pooling {name} run: {POOL_STEPS} steps in {len(legs)} run(s), layers kept {kept}, launches = "
              f"kept layers per step, {note}; objective {objective:.4f}; whole run {run_s:.2f} s [{card}]",
              flush=True)


def write_speech_corpus(root: pathlib.Path, rng, eval_speakers: int = 12, train: bool = True) -> tuple:
    """A LibriSpeech-layout tree (``<spk>/<chapter>/<spk>-<chapter>-<utt>.wav``
    and ``<spk>-<chapter>.trans.txt``): a train split of ``SPEECH_TRAIN``
    utterances over 12 speakers (left out without ``train``) and four eval
    splits of ``SPEECH_EVAL`` over ``eval_speakers`` each (12: every
    utterance its own speaker), noise over a speaker's tone, each transcript
    random words at ~``SPEECH_CHARS_PER_S`` characters a second (so every
    row's frames, ~50 a second, cover its label). Returns ({split key of
    data.module: directory}, seconds of audio per split)."""
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    splits = [("train", "train_dir", SPEECH_TRAIN, SPEECH_TRAIN_S)] + [
        (name, f"{name}_dir", SPEECH_EVAL, SPEECH_EVAL_S)
        for name in ("val_clean", "val_other", "test_clean", "test_other")]
    dirs, seconds = {}, {}
    for i, (split, key, n, (lo, hi)) in enumerate(splits):
        if split == "train" and not train:
            continue
        seconds[split] = 0.0
        for u in range(n):
            spk, chapter = 1000 + 50 * i + u % (12 if split == "train" else eval_speakers), 7 + u % 2
            d = root / split / str(spk) / str(chapter)
            d.mkdir(parents=True, exist_ok=True)
            sec = float(rng.uniform(lo, hi))
            t = np.arange(int(sec * 16000)) / 16000
            write_wav(d / f"{spk}-{chapter}-{u:04d}.wav",
                      (0.05 * np.sin(2 * np.pi * (100 + 7 * (spk % 50)) * t)
                       + rng.normal(0, 0.05, t.shape)).astype(np.float32))
            words, chars = [], 0
            while chars < SPEECH_CHARS_PER_S * sec:
                words.append("".join(rng.choice(letters, int(rng.integers(2, 9)))))
                chars += len(words[-1]) + 1
            with open(d / f"{spk}-{chapter}.trans.txt", "a") as f:
                f.write(f"{spk}-{chapter}-{u:04d} {' '.join(words)}\n")
            seconds[split] += sec
        dirs[key] = root / split
    return dirs, seconds


def speech_args(tmp: pathlib.Path) -> list:
    """Phase 16's corpus and shards (``write_speech_corpus`` under
    ``tmp / "librispeech"``) as run overrides."""
    splits = ("train", "val_clean", "val_other", "test_clean", "test_other")
    return [*(f"data.module.{split}_dir={tmp / 'librispeech' / split}" for split in splits),
            f"data.module.shards_dir={tmp / 'speech_shards'}"]


def mt_args(tmp: pathlib.Path) -> list:
    """Phase 18's corpus and shards: phase 16's training split, its own
    eval splits of 2 speakers."""
    splits = ("val_clean", "val_other", "test_clean", "test_other")
    return [f"data.module.train_dir={tmp / 'librispeech' / 'train'}",
            *(f"data.module.{split}_dir={tmp / 'mt_librispeech' / split}" for split in splits),
            f"data.module.shards_dir={tmp / 'mt_shards'}", f"data.module.num_val_pairs={MT_VAL_PAIRS}"]


def speech_f32_errors() -> tuple:
    """One float32 CTC step of the speech recipe cut to 2 layers at full
    width, card against CPU from the same weights and step generator seed
    (dropout, layerdrop and SpecAugment on), on a batch of 3 rows padded to
    2 s with labels of ``SPEECH_F32_LABELS`` tokens: (loss rel error, the
    largest per-parameter max gradient error / max abs gradient, its
    parameter, the two losses)."""
    cfg = load_recipe("speech_wav2vec2_ctc", ["trainer.precision=f32"])
    tok = CharTokenizer.wav2vec2_base_960h()
    mcfg = speech_model_config(cfg, tok.vocab_size)
    mcfg = Wav2Vec2SpeechConfig(**{**mcfg.__dict__, "w2v2": Wav2Vec2Config(**{**mcfg.w2v2.__dict__, "num_layers": 2})})
    dev = torch.device("cuda")
    with torch.device("meta"):
        model = Wav2Vec2SpeechModel(mcfg)
    model.to_empty(device=dev)
    init_parameters(model, torch.Generator(device=dev).manual_seed(16))
    cpu_model = copy.deepcopy(model).cpu()
    state = TrainState.create(model, build_optimizer(cfg), seed=1)
    cpu_state = TrainState.create(cpu_model, build_optimizer(cfg), seed=1)
    rng = np.random.default_rng(16)
    lengths = np.array([32000, 21000, 9000])
    mask = np.arange(32000)[None, :] < lengths[:, None]
    labels = np.zeros((3, 40), np.int32)
    for i, n in enumerate(SPEECH_F32_LABELS):
        labels[i, :n] = rng.integers(5, tok.vocab_size, n)  # letters of the HF vocabulary
    batch = {"features": torch.from_numpy(rng.normal(0, 0.1, (3, 32000)).astype(np.float32) * mask),
             "mask": torch.from_numpy(mask), "labels": torch.from_numpy(labels),
             "label_lengths": torch.tensor(SPEECH_F32_LABELS, dtype=torch.int32)}
    _, on_card = make_train_step(SpeechTask(model, tok))(state, {k: v.cuda() for k, v in batch.items()})
    _, on_cpu = make_train_step(SpeechTask(cpu_model, tok))(cpu_state, batch)
    assert on_card["layers_run"] == on_cpu["layers_run"], "speech f32: the packages kept other layers"
    card_loss, cpu_loss = float(on_card["loss"]), float(on_cpu["loss"])
    worst, worst_name = worst_grad_error(model, cpu_model)
    return abs(card_loss - cpu_loss) / abs(cpu_loss), worst, worst_name, card_loss, cpu_loss


def check_eval_attention(rec) -> tuple:
    """The longest eval forward's layer ``RUN_ATTN_LAYER`` q/k/v and lengths
    through the forward (and, under a random upstream gradient, dq + dk/dv)
    at rate 0, each against its plain version: (summary, errors, inputs)."""
    # recorded under inference mode: a clone outside it is an ordinary tensor
    qkv, heads, lens = rec["qkv"].clone(), rec["heads"], rec["lengths"]
    lens = None if lens is None else lens.clone()
    b, t, three_hidden = qkv.shape
    hidden = three_hidden // 3
    q, k, v = (part.view(b, t, heads, hidden // heads) for part in qkv.split(hidden, dim=-1))
    lens = torch.full((b,), t, dtype=torch.int32, device="cuda") if lens is None else lens
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(16), device="cuda").to(q.dtype)
    errors, args, _ = attention_pair_errors(q, k, v, lens, 0.0, None, do)
    for out, (err, share, zeros) in errors.items():
        assert share <= 1 and zeros, f"speech eval attention {out}: err {err}, {share:.3f} of the limit"
    return (f"layer {RUN_ATTN_LAYER} B={b} T={t} lengths {lens.tolist()} {q.dtype}: "
            + ", ".join(f"{out} {share:.3f}" for out, (_, share, _) in errors.items()) + " of the limits",
            errors, args)


def speech_phase(card: str, tmp: pathlib.Path) -> None:
    """Phase 16: ``w2v2_speaker_tpu_torch.run.main`` on the speech recipe
    (``speech_wav2vec2_ctc``) at full BASE width on a LibriSpeech-layout
    corpus it writes under ``tmp``."""
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.data.librispeech import LibriSpeechDataModule

    rng = np.random.default_rng(16)
    t0 = time.perf_counter()
    _, seconds = write_speech_corpus(tmp / "librispeech", rng)
    write_s = time.perf_counter() - t0
    ckpt = tmp / "speech_ckpt"
    argv = ["+experiment=speech_wav2vec2_ctc", *speech_args(tmp), f"trainer.max_steps={SPEECH_STEPS}",
            f"trainer.val_check_interval={SPEECH_VAL_EVERY}", "callbacks=default_speech",
            f"trainer.checkpoint_dir={ckpt}", "trainer.log_dir=null", "trainer.log_every=1", "seed=16", ONE_RANK]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_ctc_launches()
    with RunProbe(profile=(SPEECH_PROFILED, SPEECH_PROFILED), task_cls=SpeechTask, longest=True,
                  dm_cls=LibriSpeechDataModule) as probe:
        t0 = time.perf_counter()
        objective = run.main(argv)
        run_s = time.perf_counter() - t0
    MEASURED["speech_ctc_launches"] = ctc_launches()
    assert MEASURED["speech_ctc_launches"] == {"ctc_alpha_beta": SPEECH_STEPS, "ctc_grad": SPEECH_STEPS}, \
        f"speech: CTC launches {MEASURED['speech_ctc_launches']} in {SPEECH_STEPS} steps (validations decode only)"
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    kept = check_steps("speech", probe, SPEECH_STEPS)
    assert max(probe.epochs) >= 1, f"speech: {SPEECH_STEPS} steps did not cross an epoch ({probe.epochs})"
    index = json.loads((ckpt / "index.json").read_text())
    best = [e["metric"] for e in index["best"]]
    assert index["last"]["step"] == SPEECH_STEPS and best == sorted(best) and all(
        "_val_wer=" in e["name"] for e in index["best"]), f"speech: index {index}"
    wers = {k: v for _, m in probe.evals for k, v in m.items() if "wer" in k}
    val = [m for _, m in probe.evals if "val_wer" in m]
    test = next(m for _, m in probe.evals if "test_clean_wer" in m)
    assert len(val) == SPEECH_STEPS // SPEECH_VAL_EVERY and "test_other_wer" in test, f"speech: {probe.evals}"
    assert all(np.isfinite(v) and v >= 0 for v in wers.values()), f"speech: WERs {wers}"
    assert objective == test["test_clean_wer"], f"speech: objective {objective}"

    rows, frames = zip(*[(b, feat_extract_output_lengths(n)) for b, n, _ in probe.shapes])
    # the longest training forward that kept layer 0 (layerdrop may have dropped it in the longest step)
    assert probe.attn["qkv"].shape[1] > 1000, f"speech: held training T {probe.attn['qkv'].shape[1]}"
    train_check, errors, args = check_run_attention(probe.attn)
    q = args[0]
    attention_rows("speech train", errors, args, {"shape": "speech_train", "dtype": "bfloat16", "rate": args[7],
                                                   "B": q.shape[0], "T": q.shape[1], "H": q.shape[2]})
    eval_check, errors, args = check_eval_attention(probe.eval_attn)
    q = args[0]
    attention_rows("speech eval", errors, args, {"shape": "speech_eval", "dtype": "bfloat16", "rate": 0.0,
                                                  "B": q.shape[0], "T": q.shape[1], "H": q.shape[2]})

    spans = probe.spans_ms(0, SPEECH_STEPS - 1)
    window = probe.step_ms(SPEECH_VAL_EVERY, SPEECH_STEPS - 1) * (SPEECH_STEPS - SPEECH_VAL_EVERY)
    audio = sum(v for _, _, v in probe.shapes[SPEECH_VAL_EVERY:]) / 16000
    in_steps = sum(spans[SPEECH_VAL_EVERY:])
    busy, window_ms, kernels, by_cat, (top_name, top_ms) = probe.busy
    waits_ms = [1e3 * w for w in probe.waits]
    losses = [round(m["loss"], 2) for _, m in probe.steps]
    f32 = speech_f32_errors()
    print(f"speech kernels vs plain on the longest training batch that kept layer {RUN_ATTN_LAYER} (longest T "
          f"{max(frames)}): {train_check}; on the longest eval batch: {eval_check}", flush=True)
    print("speech steps (B, T, ms): " + ", ".join(
        f"({b}, {t}, {ms:.2f})" for b, t, ms in zip(rows, frames, spans)) + f" [{card}]", flush=True)
    print(f"speech BASE bf16, budget 3.2 M samples: {sum(seconds.values()):.1f} s of audio written in {write_s:.2f} s "
          f"({seconds['train']:.1f} s train); shard preparation {probe.prepare_s:.3f} s; steps "
          f"{SPEECH_VAL_EVERY + 1}-{SPEECH_STEPS}: {audio:.1f} s of audio in {window:.1f} ms (CUDA events, start of "
          f"step {SPEECH_VAL_EVERY + 1} to end of step {SPEECH_STEPS}), {1e3 * audio / window:.1f} audio s per s "
          f"({1e3 * audio / in_steps:.1f} over the steps' own spans, {in_steps:.1f} ms); "
          f"host wait on the Prefetcher per step: mean {np.mean(waits_ms):.2f} ms, by step "
          f"{[round(w, 2) for w in waits_ms]}; device busy {100 * busy:.1f} % of step {SPEECH_PROFILED + 1} "
          f"({window_ms:.1f} ms, {kernels} kernels; {per_step_categories(by_cat, top_name, top_ms, 1)}); "
          f"losses {losses}; validation s {[round(m['val_seconds'], 3) for m in val]}, test "
          f"{test['test_seconds']:.3f} s; WERs {json.dumps({k: round(v, 4) for k, v in wers.items()})}; whole run "
          f"{run_s:.2f} s; layers kept {kept}; epochs read {probe.epochs}; peak {peak_gib:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held at the phase's start [{card}]", flush=True)
    print(f"speech f32 CTC step card vs cpu (2 layers, dropout on, labels {SPEECH_F32_LABELS}): loss {f32[3]:.6f} "
          f"vs {f32[4]:.6f} (rel {f32[0]:.3e}); grads max err / max abs per parameter {f32[1]:.3e} ({f32[2]}) "
          f"(limit {F32_REL_TOL})", flush=True)
    assert f32[0] < F32_REL_TOL and f32[1] < F32_REL_TOL, "speech f32 CTC step: card vs cpu differ"


def speaker_ctc_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 17: ``run.main`` on ``speaker_wav2vec2_ctc`` (frame-level CTC
    over 5994 speakers + the blank, its bias 100; mean-pooled test) at full
    BASE width on phase 13's shards."""
    from w2v2_speaker_tpu_torch import run

    argv = ["+experiment=speaker_wav2vec2_ctc", f"data.shards.samples_per_shard={RUN_SHARD}",
            f"trainer.max_steps={SPEAKER_CTC_STEPS}", f"trainer.val_check_interval={SPEAKER_CTC_STEPS}", "seed=17",
            *corpus_args(wav_dir, trials, shards, tmp / "ctc_ckpt")]
    reset_launches()
    with RunProbe() as probe:
        t0 = time.perf_counter()
        objective = run.main(argv)
        run_s = time.perf_counter() - t0
    kept = check_steps("speaker ctc", probe, SPEAKER_CTC_STEPS)
    assert objective is not None and np.isfinite(objective) and 0 <= objective <= 1, f"speaker ctc: {objective}"
    steady = probe.step_ms(1, SPEAKER_CTC_STEPS - 1)
    print(f"speaker ctc BASE bf16 B={probe.shapes[0][0]}: losses {[round(m['loss'], 3) for _, m in probe.steps]}, "
          f"{steady:.3f} ms/step (steps 2-{SPEAKER_CTC_STEPS}, CUDA events), layers kept {kept}, launches = kept "
          f"layers per step; test EER {objective:.4f}; whole run {run_s:.2f} s [{card}]", flush=True)


def mt_checks(label, probe, steps) -> list:
    """``check_steps`` of a multitask run, and each step's logged loss equal
    to speech_weight x loss_speech + speaker_weight x loss_speaker (1, 1),
    both parts finite; the layers kept."""
    kept = check_steps(label, probe, steps)
    for step, m in probe.steps:
        parts = m["loss_speech"] + m["loss_speaker"]
        assert np.isfinite(m["loss_speech"]) and np.isfinite(m["loss_speaker"]) and abs(
            m["loss"] - parts) <= MT_LOSS_RTOL * abs(parts), f"{label} step {step}: {m}"
        assert 0 <= m["accuracy"] <= 1, f"{label} step {step}: accuracy {m['accuracy']}"
    return kept


def multitask_phase(card: str, tmp: pathlib.Path) -> None:
    """Phase 18: ``run.main`` on ``multitask_wav2vec2`` (one BASE backbone
    under the CTC letter head and the speaker CE head, then AAM) at full
    width on phase 16's training split and eval splits of repeated
    speakers, then the predict twin on its best checkpoint."""
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.data.librispeech import LibriSpeechDataModule
    from w2v2_speaker_tpu_torch.train.multitask_task import MultitaskTask

    rng = np.random.default_rng(18)
    dirs, seconds = write_speech_corpus(tmp / "mt_librispeech", rng, eval_speakers=MT_EVAL_SPEAKERS, train=False)
    ckpt = tmp / "mt_ckpt"
    argv = ["+experiment=multitask_wav2vec2", *mt_args(tmp), f"trainer.max_steps={MT_STEPS}",
            f"trainer.val_check_interval={MT_VAL_EVERY}", "trainer.log_dir=null", "trainer.log_every=1",
            "seed=16", ONE_RANK]  # phase 16's seed: its batches
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with RunProbe(profile=(MT_PROFILED, MT_PROFILED), task_cls=MultitaskTask, longest=True,
                  dm_cls=LibriSpeechDataModule) as probe:
        t0 = time.perf_counter()
        objective = run.main([*argv, f"trainer.checkpoint_dir={ckpt}"])
        run_s = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    kept = mt_checks("multitask", probe, MT_STEPS)
    assert max(probe.epochs) >= 1, f"multitask: {MT_STEPS} steps did not cross an epoch ({probe.epochs})"
    index = json.loads((ckpt / "index.json").read_text())
    best = [e["metric"] for e in index["best"]]
    # the JAX package ranks every kind but speech by val_eer (_train_loop :1129)
    assert index["last"]["step"] == MT_STEPS and best == sorted(best) and all(
        "_val_eer=" in e["name"] for e in index["best"]), f"multitask: index {index}"
    val = [m for _, m in probe.evals if "val_eer" in m]
    test = next(m for _, m in probe.evals if "test_eer" in m)
    assert len(val) == MT_STEPS // MT_VAL_EVERY, f"multitask: validations {probe.evals}"
    for m in (*val, test):
        wers = [v for k, v in m.items() if k.endswith("wer") or k.startswith("val_wer")]
        assert wers and all(np.isfinite(v) and v >= 0 for v in wers), f"multitask: WERs {m}"
        eer = m.get("val_eer", m.get("test_eer"))
        assert 0 <= eer <= 1 and 0 <= m.get("val_mdc", m.get("test_mdc")) <= 1, f"multitask: EER {m}"
    assert "test_other_wer" in test and objective == test["test_eer"], f"multitask: objective {objective}, {test}"

    rows, frames = zip(*[(b, feat_extract_output_lengths(n)) for b, n, _ in probe.shapes])
    train_check, errors, args = check_run_attention(probe.attn)
    q = args[0]
    attention_rows("multitask train", errors, args, {"shape": "multitask_train", "dtype": "bfloat16",
                                                      "rate": args[7], "B": q.shape[0], "T": q.shape[1],
                                                      "H": q.shape[2]})
    spans = probe.spans_ms(0, MT_STEPS - 1)
    window = probe.step_ms(MT_VAL_EVERY, MT_STEPS - 1) * (MT_STEPS - MT_VAL_EVERY)
    audio = sum(v for _, _, v in probe.shapes[MT_VAL_EVERY:]) / 16000
    busy, window_ms, kernels, by_cat, (top_name, top_ms) = probe.busy
    waits_ms = [1e3 * w for w in probe.waits]
    losses = [(round(m["loss_speech"], 2), round(m["loss_speaker"], 3)) for _, m in probe.steps]

    # 4 steps with the AAM head on the same shards
    with RunProbe(task_cls=MultitaskTask, dm_cls=LibriSpeechDataModule) as aam:
        aam_objective = run.main([*argv, "optim/loss=ctc_aam", f"trainer.max_steps={MT_AAM_STEPS}",
                                  f"trainer.val_check_interval={MT_AAM_STEPS}",
                                  f"trainer.checkpoint_dir={tmp / 'mt_aam_ckpt'}"])
    aam_kept = mt_checks("multitask aam", aam, MT_AAM_STEPS)
    assert 0 <= aam_objective <= 1, f"multitask aam: objective {aam_objective}"

    # the predict twin on the best ctc_ce checkpoint over the test split's files
    folder = dirs["test_clean_dir"]
    files = sorted(str(f.relative_to(folder)) for f in folder.rglob("*.wav"))
    by_speaker = {}
    for rel in files:
        by_speaker.setdefault(rel.split("/")[0], []).append(rel.removesuffix(".wav"))
    pair_file = tmp / "mt_trials.txt"
    save_evaluation_pairs(generate_validation_pairs(by_speaker, MT_VAL_PAIRS, seed=18), pair_file)
    vocab = CharTokenizer.load(tmp / "mt_shards" / "vocab.json").vocab_size
    overrides = ["network=wav2vec2_multitask", "optim/loss=ctc_ce", "trainer.precision=bf16",
                 f"network.explicit_vocab_size={vocab}", f"load_network_from_checkpoint={ckpt / 'best'}",
                 f"data.dataloader.test_pad_to_multiple={PREDICT_PAD}",
                 f"data.dataloader.test_batch_size={PREDICT_BATCH}", f"predict_folder_path={folder}",
                 f"pair_prediction_path={pair_file}"]
    reset_launches()
    scores, pairs = read_scores(predict.main(overrides))
    got = launches()
    batches = -(-len(files) // PREDICT_BATCH)
    assert got == {"flash_attention_fwd": 12 * batches, "flash_attention_bwd_dq": 0,
                   "flash_attention_bwd_dkv": 0, "conv_encoder": 0}, f"multitask predict launched {got}"
    model = build_predict_model(load_config(predict.CONFIG_DIR, "predict", overrides))
    samples = [SpeakerSample(rel, normalize_waveform(load_raw_audio(folder / rel))) for rel in files]
    direct = {e.sample_id: e.embedding for e in extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH)}
    del model
    same = float(np.abs(cosine_scores(direct, pairs) - scores).max())
    assert np.all((scores >= 0) & (scores <= 1)) and same <= MT_SAME_ATOL, \
        f"multitask predict: scores vs direct differ by {same}"

    print(f"multitask kernels vs plain on the longest training batch that kept layer {RUN_ATTN_LAYER} "
          f"(longest T {max(frames)}): {train_check}", flush=True)
    print("multitask steps (B, T, ms): " + ", ".join(
        f"({b}, {t}, {ms:.2f})" for b, t, ms in zip(rows, frames, spans)) + f" [{card}]", flush=True)
    print(f"multitask BASE bf16 ctc_ce, budget 3.2 M samples: {sum(seconds.values()):.1f} s of eval audio written "
          f"(eval speakers {MT_EVAL_SPEAKERS} a split); shard preparation {probe.prepare_s:.3f} s; steps "
          f"{MT_VAL_EVERY + 1}-{MT_STEPS}: {audio:.1f} s of audio in {window:.1f} ms (CUDA events), "
          f"{1e3 * audio / window:.1f} audio s per s ({1e3 * audio / sum(spans[MT_VAL_EVERY:]):.1f} over the steps' "
          f"own spans); host wait on the Prefetcher per step: mean {np.mean(waits_ms):.2f} ms, by step "
          f"{[round(w, 2) for w in waits_ms]}; device busy {100 * busy:.1f} % of step {MT_PROFILED + 1} "
          f"({window_ms:.1f} ms, {kernels} kernels; {per_step_categories(by_cat, top_name, top_ms, 1)}); "
          f"(speech, speaker) losses {losses}; validations "
          f"{json.dumps([{k: round(v, 4) for k, v in m.items()} for m in val])}; "
          f"test {json.dumps({k: round(v, 4) for k, v in test.items()})}; whole run {run_s:.2f} s; layers kept "
          f"{kept}; epochs read {probe.epochs}; peak {peak_gib:.2f} GiB above the {held / 2**30:.2f} GiB held at "
          f"the phase's start [{card}]", flush=True)
    print(f"multitask ctc_aam: {MT_AAM_STEPS} steps, (speech, speaker) losses "
          f"{[(round(m['loss_speech'], 2), round(m['loss_speaker'], 3)) for _, m in aam.steps]}, "
          f"{aam.step_ms(1, MT_AAM_STEPS - 1):.3f} ms/step (steps 2-{MT_AAM_STEPS}), layers kept {aam_kept}, test EER "
          f"{aam_objective:.4f}; predict twin on the best ctc_ce checkpoint: {len(files)} files, {len(pairs)} "
          f"trials, launches {got}, scores vs extract_embeddings + cosine max diff {same:.3e} [{card}]", flush=True)


def triplet_phase(card: str, tmp: pathlib.Path) -> None:
    """Phase 19: ``run.main`` on ``speaker_wav2vec2_triplet`` and
    ``speaker_wav2vec2_triplet_ce`` at full BASE width, B=66, 4 steps in
    one dispatch each, on a corpus of its own in the recipes' runs of 4,
    with a sample queue below the epoch's size."""
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.runtime import experiment as rexp

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wav_dir, trials, _ = write_run_corpus(tmp / "triplet", np.random.default_rng(19), TRIPLET_UTTERANCES)
    epoch = (RUN_SPEAKERS - RUN_TEST - RUN_VAL) * TRIPLET_UTTERANCES
    draws = []  # per epoch, the samples the processor had read at each batch it drew
    orig_call = rexp.TripletBatchProcessor.__call__

    def counted_call(proc, samples):
        read, at = [0], []
        draws.append(at)

        def counted():
            for sample in samples:
                read[0] += 1
                yield sample

        orig_draw = proc._draw
        proc._draw = lambda by_speaker: (at.append(read[0]), orig_draw(by_speaker))[1]
        return orig_call(proc, counted())

    report = []
    rexp.TripletBatchProcessor.__call__ = counted_call
    try:
        for recipe in ("speaker_wav2vec2_triplet", "speaker_wav2vec2_triplet_ce"):
            argv = [f"+experiment={recipe}", f"data.shards.samples_per_shard={RUN_SHARD + 2}",
                    f"data.dataloader.queue_size={TRIPLET_QUEUE}", f"trainer.max_steps={TRIPLET_STEPS}",
                    f"trainer.val_check_interval={TRIPLET_STEPS}", "seed=19",
                    *corpus_args(wav_dir, trials, tmp / "triplet_shards", tmp / f"{recipe}_ckpt")]
            draws.clear()
            reset_launches()
            with RunProbe() as probe:
                objective = run.main(argv)
            kept = check_steps(recipe, probe, TRIPLET_STEPS)
            assert 0 <= objective <= 1, f"{recipe}: objective {objective}"
            for labels in probe.labels:
                _, counts = torch.unique(labels, return_counts=True)
                assert labels.numel() == 66 and len(counts) >= 2 and int(counts.min()) >= 2, \
                    f"{recipe}: a batch without a positive for every anchor: {counts.tolist()}"
            first = draws[0]
            assert len(first) >= TRIPLET_STEPS and first[TRIPLET_STEPS - 1] < epoch, \
                f"{recipe}: the first epoch's batches were drawn after reading {first} of {epoch} samples"
            spans = probe.spans_ms(0, TRIPLET_STEPS - 1)
            report.append(f"{recipe}: losses {[round(m['loss'], 4) for _, m in probe.steps]}, steps "
                          f"{probe.step_ms(0, TRIPLET_STEPS - 1):.3f} ms/step over the dispatch (spans "
                          f"{[round(x, 2) for x in spans]}), speakers per batch "
                          f"{[len(torch.unique(lab)) for lab in probe.labels]}, batches drawn after reading "
                          f"{first} of the epoch's {epoch} samples, layers kept {kept}, test EER {objective:.4f}")
    finally:
        rexp.TripletBatchProcessor.__call__ = orig_call
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    print(f"triplet BASE bf16 B=66, runs of 4, queue {TRIPLET_QUEUE}: {'; '.join(report)}; peak {peak_gib:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB held at the phase's start [{card}]", flush=True)


class ConvRecorder:
    """Keeps the inputs of the first training forward's fused conv calls
    (``StridedConvFusedFunction.apply``), as (x, w in x's type, bias, LN
    scale, LN bias), for the length of a ``with`` block."""

    def __init__(self):
        self.layers = []

    def __enter__(self):
        orig = ce.StridedConvFusedFunction.apply

        def apply(x, w, bias, scale, shift, *rest):
            if torch.is_grad_enabled() and len(self.layers) < 6:
                self.layers.append(tuple(None if t is None else t.detach().contiguous().clone()
                                         for t in (x, w.to(x.dtype), bias, scale, shift)))
            return orig(x, w, bias, scale, shift, *rest)

        ce.StridedConvFusedFunction.apply = apply  # shadows the inherited classmethod
        return self

    def __exit__(self, *exc):
        del ce.StridedConvFusedFunction.apply


def options_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 20: item 5's options on phase 13's shards: (a) the conv stack
    alone on the fused conv kernel, trained; (b) 12 layer-ensemble
    embeddings at the test; (c) frame-level test embeddings."""
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.runtime import predict as rpredict

    common = ["+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}", "seed=20"]

    # (a) wav2vec_feature_encoder_only on the fused conv: 6 conv launches a step, no attention
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with RunProbe(profile=(LITE_STEPS - 1, LITE_STEPS - 1), memory=True) as probe, \
            ConvRecorder() as conv:
        lite_objective = run.main([*common, "network.wav2vec_feature_encoder_only=true",
                                   "network.conv_impl=fused_pallas",
                                   f"trainer.max_steps={LITE_STEPS}", f"trainer.val_check_interval={LITE_STEPS}",
                                   *corpus_args(wav_dir, trials, shards, tmp / "lite_ckpt")])
    peak_gib = probe.peak_gib(held)
    assert [s for s, _ in probe.steps] == list(range(1, LITE_STEPS + 1)) and all(
        np.isfinite(m["loss"]) for _, m in probe.steps), f"lite: steps {probe.steps}"
    for step, layers, got in probe.per_step():
        assert layers is None and got == {**{k: 0 for k in ATTENTION}, "conv_encoder": 6}, \
            f"lite step {step}: launched {got}"
    assert 0 <= lite_objective <= 1, f"lite: objective {lite_objective}"
    assert len(conv.layers) == 6 and conv.layers[0][0].shape[0] == 66, "lite: conv inputs not recorded"
    lite_row = check_conv("lite_train", conv.layers)
    lite_ms = probe.step_ms(1, LITE_STEPS - 2)
    del conv
    busy, window_ms, kernels, by_cat, (top_name, top_ms) = probe.busy
    by_time, by_memory = probe.ops
    gib = [[round((x - held) / 2**30, 2) for x in m] for m in probe.mem]
    print(f"lite profile of step {LITE_STEPS} (torch.profiler): device busy {100 * busy:.1f} % of {window_ms:.1f} ms, "
          f"{kernels} kernels; {per_step_categories(by_cat, top_name, top_ms, 1)}; ops by self device ms "
          f"{[(op, shapes, round(ms, 3)) for op, shapes, ms, _ in by_time]}; ops by device memory allocated and "
          f"kept (GiB) {[(op, shapes, round(g, 3)) for op, shapes, _, g in by_memory]}; memory above the phase's "
          f"start per step (GiB: at its start, after its forward, its peak) {gib} [{card}]", flush=True)
    print(f"lite (conv stack alone, fused conv) BASE bf16 B=66: losses {[round(m['loss'], 4) for _, m in probe.steps]}, "
          f"{lite_ms:.3f} ms/step (CUDA events, steps 2-{LITE_STEPS - 1}), launches per step {probe.per_step()[0][2]}, "
          f"conv kernel at the first training batch's layer inputs T_in {lite_row['T_in']}: max abs err "
          f"{lite_row['max_abs_err']:.3e}, {lite_row['limit_share']:.3f} of the limit, {lite_row['ms']:.3f} ms "
          f"(bound {lite_row['bound_ms']:.3f}, plain {lite_row['plain_ms']:.3f}, cuDNN route "
          f"{lite_row['library_ms']:.3f}); test EER {lite_objective:.4f}; peak {peak_gib:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held at the phase's start [{card}]", flush=True)

    # (b) 12 layer ensembles at the test (weights as initialised: fit_model=false)
    extracted = []
    orig_extract = rpredict.extract_embeddings

    def recording_extract(*a, **kw):
        out = orig_extract(*a, **kw)
        extracted.append(out)
        return out

    rpredict.extract_embeddings = recording_extract
    try:
        reset_launches()
        ens_objective = run.main([*common, "network.use_transformers_as_ensembles=true",
                                  f"network.num_ensembles={ENSEMBLES}", "fit_model=false",
                                  *corpus_args(wav_dir, trials, shards, tmp / "ens_ckpt")])
    finally:
        rpredict.extract_embeddings = orig_extract
    samples = extracted[-1]
    assert all(isinstance(e.embedding, list) and len(e.embedding) == ENSEMBLES
               and all(x.shape == (BASE_CONFIG.hidden_size,) for x in e.embedding) for e in samples), \
        "ensembles: not 12 pooled embeddings per utterance"
    test_pairs = load_evaluation_pairs(trials)
    by_id = {e.sample_id: e for e in samples}
    pairs = [(by_id[p.sample1_id], by_id[p.sample2_id]) for p in test_pairs]
    evaluator = CosineDistanceEvaluator()
    ens_scores = np.asarray(evaluator._compute_prediction_scores(pairs))
    per_layer = np.mean([evaluator._compute_prediction_scores(
        [(EmbeddingSample(a.sample_id, a.embedding[i]), EmbeddingSample(b.sample_id, b.embedding[i]))
         for a, b in pairs]) for i in range(ENSEMBLES)], axis=0)
    ens_same = float(np.abs(ens_scores - per_layer).max())
    assert ens_same <= ENSEMBLE_SAME_ATOL, f"ensembles: scores vs the per-layer mean differ by {ens_same}"
    metrics = evaluator.evaluate(test_pairs, samples)
    assert metrics["eer"] == ens_objective and 0 <= ens_objective <= 1, f"ensembles: {metrics} vs {ens_objective}"
    ens_f32 = ensemble_f32_error()
    assert ens_f32 < F32_REL_TOL, f"ensembles: f32 card vs cpu {ens_f32}"
    print(f"ensembles BASE bf16: {len(samples)} test utterances x {ENSEMBLES} pooled layer embeddings, launches "
          f"{launches()}; ensemble scores vs the mean of the per-layer cosine scores max diff {ens_same:.3e} over "
          f"{len(pairs)} trials; test EER {ens_objective:.4f}; f32 ensemble embeddings card vs cpu max err / max abs "
          f"{ens_f32:.3e} (limit {F32_REL_TOL}) [{card}]", flush=True)

    # (c) frame-level test embeddings ([T, D]) scored by the frame-level cosine
    extracted.clear()
    rpredict.extract_embeddings = recording_extract
    try:
        frames_objective = run.main([*common, "network.stat_pooling_type=none", "network.test_stat_pooling_type=none",
                                     f"trainer.max_steps={FRAMES_STEPS}", f"trainer.val_check_interval={FRAMES_STEPS}",
                                     *corpus_args(wav_dir, trials, shards, tmp / "frames_ckpt")])
    finally:
        rpredict.extract_embeddings = orig_extract
    shapes = [e.embedding.shape for e in extracted[-1]]
    assert all(len(sh) == 2 and sh[1] == BASE_CONFIG.hidden_size and sh[0] > 150 for sh in shapes), \
        f"frames: test embeddings {shapes}"
    assert 0 <= frames_objective <= 1, f"frames: objective {frames_objective}"
    print(f"frames (ce_no_pool, test pooling none) BASE bf16: {FRAMES_STEPS} steps, test embeddings [T, D] with T "
          f"{min(sh[0] for sh in shapes)}-{max(sh[0] for sh in shapes)}, test EER {frames_objective:.4f} [{card}]",
          flush=True)


def ensemble_f32_error() -> float:
    """``compute_ensemble_embeddings`` of a float32 BASE speaker model
    (seeded) on 3 padded utterances, card against CPU: the largest max abs
    error / max abs over the 12 layers."""
    cfg = Wav2Vec2SpeakerConfig(w2v2=BASE_CONFIG)
    dev = torch.device("cuda")
    with torch.device("meta"):
        model = Wav2Vec2SpeakerModel(cfg, num_speakers=NUM_SPEAKERS)
    model.to_empty(device=dev)
    init_parameters(model, torch.Generator(device=dev).manual_seed(20))
    model.eval().requires_grad_(False)
    rng = np.random.default_rng(20)
    n = int(max(ENSEMBLE_F32_S) * 16000)
    lengths = np.array([int(s * 16000) for s in ENSEMBLE_F32_S])
    mask = np.arange(n)[None, :] < lengths[:, None]
    wav = torch.from_numpy(rng.normal(0, 0.1, (len(lengths), n)).astype(np.float32) * mask)
    mask = torch.from_numpy(mask)
    with torch.inference_mode():
        on_card = [e.cpu() for e in model.compute_ensemble_embeddings(wav.to(dev), mask.to(dev), ENSEMBLES)]
        on_cpu = copy.deepcopy(model).cpu().compute_ensemble_embeddings(wav, mask, ENSEMBLES)
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(on_card, on_cpu))


def fbank_phase(card: str) -> None:
    """Phase 21: the fbank and the frontend, card against CPU, float32."""
    samples = sorted(serving_samples(np.random.default_rng(21)), key=lambda s: len(s.wav))
    worst = {"fbank": 0.0, "frontend 40": 0.0, "frontend 80": 0.0, "row alone": 0.0}
    fronts = {m: FbankFrontend(torch.nn.Identity(), FbankConfig(n_mels=m)) for m in (40, 80)}
    cfg = FbankConfig()
    for i in range(0, len(samples), FBANK_BATCH):
        batch = collate_pad_right([s.wav for s in samples[i:i + FBANK_BATCH]], pad_to_multiple=FBANK_PAD,
                                  dtype=np.float32)
        wav, lengths = torch.from_numpy(batch.values), torch.from_numpy(batch.mask).sum(-1)
        valid = [num_frames(int(n), cfg) for n in lengths]

        def valid_err(a, b):
            return max(float((a[j, :n] - b[j, :n]).abs().max()) for j, n in enumerate(valid))

        on_card = log_mel_filterbank(wav.cuda(), cfg, lengths.cuda()).cpu()
        worst["fbank"] = max(worst["fbank"], valid_err(on_card, log_mel_filterbank(wav, cfg, lengths)))
        for j, n in enumerate(lengths.tolist()):
            alone = log_mel_filterbank(wav[j:j + 1, :n].cuda(), cfg).cpu()
            worst["row alone"] = max(worst["row alone"], float((on_card[j, :valid[j]] - alone[0]).abs().max()))
        mask = torch.from_numpy(batch.mask)
        for m, front in fronts.items():
            got, fmask = front.features(wav.cuda(), mask.cuda())
            want, want_mask = front.features(wav, mask)
            assert torch.equal(fmask.cpu(), want_mask) and not got[~fmask].any(), f"frontend {m}: padding frames"
            worst[f"frontend {m}"] = max(worst[f"frontend {m}"], valid_err(got.cpu(), want))
    assert all(err <= FBANK_ATOL for err in worst.values()), f"fbank card vs cpu: {worst}"
    wav_card, mask_card = wav.cuda(), mask.cuda()
    fbank_ms = cuda_ms(lambda: log_mel_filterbank(wav_card, cfg, lengths.cuda()), 10)
    front_ms = {m: cuda_ms(lambda f=front: f.features(wav_card, mask_card), 10) for m, front in fronts.items()}
    frames = on_card.shape[1]
    bound = 4 * frames * (cfg.n_fft * (cfg.n_fft // 2 + 1) * 2 * 2 + (cfg.n_fft // 2 + 1) * cfg.n_mels * 2) \
        / PEAK_OPS[torch.float32] * 1e3

    # the x-vector recipe's network at full width (random weights): bucketed vs alone
    _, task = family_task("speaker_xvector", 21)
    model = task.model.eval().requires_grad_(False)
    reset_launches()
    served = {e.sample_id: e.embedding for e in extract_embeddings(model, samples, FBANK_PAD, FBANK_BATCH)}
    alone = unpadded_embeddings(embed, model, samples)
    ratio = padding_ratio(served, alone)
    assert ratio <= MAX_PAD_RATIO and sum(launches().values()) == 0, f"x-vector serving: ratio {ratio}"
    print(f"fbank f32 card vs cpu over the valid frames of {len(samples)} utterances "
          f"({min(UTTERANCE_S)}-{max(UTTERANCE_S)} s, buckets of {FBANK_PAD}, batch {FBANK_BATCH}): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (limit {FBANK_ATOL}); the longest batch "
          f"[{FBANK_BATCH}, {wav.shape[1]}] -> {frames} frames: fbank {fbank_ms:.3f} ms/batch (bound of its "
          f"float32 products {bound:.3f} ms), frontend 40 mels {front_ms[40]:.3f}, 80 mels {front_ms[80]:.3f} "
          f"ms/batch; x-vector (full width, f32) bucketed vs unpadded batch-1: distance ratio {ratio:.3e} (limit "
          f"{MAX_PAD_RATIO}); launches {launches()} [{card}]", flush=True)


def family_task(recipe: str, seed: int, overrides=()):
    """(config, task) of ``recipe``: the model on the card, its weights
    drawn from ``seed``."""
    cfg = load_recipe(recipe, list(overrides))
    dev = torch.device("cuda")
    with torch.device("meta"):
        task, _ = build_model_and_task(cfg, NUM_SPEAKERS)
    task.model.to_empty(device=dev)
    init_parameters(task.model, torch.Generator(device=dev).manual_seed(seed))
    return cfg, task


def rel_error(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """max |got - want| / max(max |want|, ``floor``) in float64 (0 for two
    zero tensors)."""
    err, scale = (got.double() - want.double()).abs().max(), max(float(want.double().abs().max()), floor)
    return float(err / scale) if scale > 0 else (0.0 if err == 0 else float("inf"))


def family_f32_readings(recipe: str, overrides=(), label=None) -> dict:
    """The forward and backward of one float32 training step of
    ``recipe``'s network at full width on 3 rows padded to 2 s, on the card
    and on the CPU from the same weights, and the same in float64 on the
    CPU: the loss and the worst updated running statistic card against
    CPU (relative), the gradients' distance from the float64 ones on the
    card and on the CPU (the norm of the error over the norm of all
    gradients), the worst per-parameter gradient error card against CPU
    (max abs over max abs, as phases 7 and 11 read it) and against float64
    on either device (floored at ``FAMILY_GRAD_FLOOR`` of the largest
    gradient), and a report of them. Weights and data come from the
    recipe's (or ``label``'s) ``FAMILY_F32_SEEDS``; ``overrides`` go to
    the recipe."""
    seed = FAMILY_F32_SEEDS[label or recipe]
    cfg, task = family_task(recipe, seed, overrides)
    models = {"card": task.model, "cpu": copy.deepcopy(task.model).cpu(),
              "f64": copy.deepcopy(task.model).cpu().double()}
    rng = np.random.default_rng(seed)
    lengths = np.array(FAMILY_F32_LENGTHS)
    mask = np.arange(lengths.max())[None, :] < lengths[:, None]
    batch = {"features": torch.from_numpy(rng.normal(0, 0.1, mask.shape) * mask),
             "mask": torch.from_numpy(mask), "labels": torch.from_numpy(rng.integers(0, NUM_SPEAKERS, 3))}
    loss = {}
    for name, model in models.items():
        dtype, dev = (torch.float64, "cpu") if name == "f64" else (torch.float32, "cuda" if name == "card" else "cpu")
        rows = {k: (v.to(dtype) if k == "features" else v).to(dev) for k, v in batch.items()}
        out, _ = SpeakerTask(model, task.mode).loss_fn(rows, torch.Generator().manual_seed(seed))
        out.backward()
        loss[name] = float(out.detach())
    cpu_buffers = dict(models["cpu"].named_buffers())
    grads = {name: grads_of(model) for name, model in models.items()}
    exact = grads["f64"]
    floor = FAMILY_GRAD_FLOOR * max(float(g.abs().max()) for g in exact.values())
    r = {"loss": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
         "stats": max([rel_error(b.cpu(), cpu_buffers[n]) for n, b in models["card"].named_buffers()], default=0.0),
         "direct": worst_grad_error(models["card"], models["cpu"])}
    for dev in ("card", "cpu"):
        r[f"norm_{dev}"] = float(torch.stack([(g.double() - exact[n]).norm() for n, g in grads[dev].items()]).norm()
                                 / torch.stack([g.norm() for g in exact.values()]).norm())
        r[f"worst_{dev}"] = max(((rel_error(g, exact[n], floor), n) for n, g in grads[dev].items()))
    r["limit"] = max(F32_REL_TOL, FAMILY_F64_FACTOR * r["norm_cpu"])
    r["report"] = (
        f"f32 step card vs cpu (B=3 padded to 2 s): loss rel {r['loss']:.3e}, running statistics {r['stats']:.3e} "
        f"(limit {F32_REL_TOL}); grads max err / max abs card vs cpu {r['direct'][0]:.3e} ({r['direct'][1]}); "
        f"against the float64 step: norm of the error over the norm {r['norm_card']:.3e} on the card, "
        f"{r['norm_cpu']:.3e} on the cpu (limit {r['limit']:.3e}: max({F32_REL_TOL}, {FAMILY_F64_FACTOR}x the cpu's)); "
        f"per parameter (floor {FAMILY_GRAD_FLOOR} of the largest) the card's worst {r['worst_card'][0]:.3e} "
        f"({r['worst_card'][1]}), the cpu's {r['worst_cpu'][0]:.3e} ({r['worst_cpu'][1]})")
    return r


def family_f32_step(recipe: str, overrides=(), label=None) -> str:
    """``family_f32_readings`` held to its limits: the loss and the running
    statistics card against CPU within ``F32_REL_TOL``; the card's
    gradients as close to the float64 ones as ``F32_REL_TOL``, or as
    ``FAMILY_F64_FACTOR`` times the CPU float32 step's distance. Returns
    the report."""
    r = family_f32_readings(recipe, overrides, label)
    assert r["loss"] < F32_REL_TOL and r["stats"] < F32_REL_TOL and r["norm_card"] < r["limit"], \
        f"{label or recipe}: {r['report']}"
    return r["report"]


def family_run(card: str, tmp: pathlib.Path, recipe: str, wav_dir, trials, shards, steps: int = FAMILY_STEPS,
               extra=(), trainer=None, label=None, note: str = "") -> tuple:
    """``run.main`` on ``recipe`` with ``extra`` over phase 13's shards,
    ``steps`` steps (with ``trainer`` None, a validation after the last;
    else ``trainer``'s overrides), the last step profiled: finite losses,
    no kernel launched, the test EER in [0, 1]. Prints ``label`` (the
    recipe's name without one; it also names the checkpoint directory),
    ms/step (CUDA events, steps 2 to ``steps`` - 1), the busy share and
    device ms by category of the last step, its top ops, the peak memory
    and ``note``; returns (the objective, the checkpoint directory)."""
    from w2v2_speaker_tpu_torch import run

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    label = label or recipe
    ckpt = tmp / f"{label}_ckpt"
    if trainer is None:
        trainer = [f"trainer.max_steps={steps}", f"trainer.val_check_interval={steps}"]
    reset_launches()
    t0 = time.perf_counter()
    with RunProbe(profile=(steps - 1, steps - 1), memory=True) as probe:
        objective = run.main([f"+experiment={recipe}", f"data.shards.samples_per_shard={RUN_SHARD}", "seed=22",
                              *trainer, *corpus_args(wav_dir, trials, shards, ckpt), *extra])
    run_s = time.perf_counter() - t0
    peak_gib = probe.peak_gib(held)
    assert [s for s, _ in probe.steps] == list(range(1, steps + 1)), f"{label}: steps {probe.steps}"
    assert all(np.isfinite(m["loss"]) for _, m in probe.steps), f"{label}: non-finite loss"
    zero = {k: 0 for k in launches()}
    assert all(got == zero for _, _, got in probe.per_step()) and launches() == zero, \
        f"{label}: a kernel was launched {launches()}"
    assert objective is not None and 0 <= objective <= 1, f"{label}: objective {objective}"
    busy, window_ms, kernels, by_cat, (top_name, top_ms) = probe.busy
    by_time, _ = probe.ops
    rows, t = probe.shapes[0][:2]
    evals = [sorted(k for k in m if k.endswith("eer")) for _, m in probe.evals]
    print(f"{label} f32 B={rows} x {t}: losses {[round(m['loss'], 4) for _, m in probe.steps]}; "
          f"{probe.step_ms(1, steps - 2):.3f} ms/step (CUDA events, steps 2-{steps - 1}; spans "
          f"{[round(x, 2) for x in probe.spans_ms(0, steps - 1)]}); step {steps} profiled: device busy "
          f"{100 * busy:.1f} % of {window_ms:.1f} ms, {kernels} kernels; "
          f"{per_step_categories(by_cat, top_name, top_ms, 1)}; ops by self device ms "
          f"{[(op, shapes, round(ms, 3)) for op, shapes, ms, _ in by_time]}; evaluations {evals}; test EER "
          f"{objective:.4f}; whole run {run_s:.2f} s; launches per step {zero} (no kernel on this path); peak "
          f"{peak_gib:.2f} GiB above the {held / 2**30:.2f} GiB held at the phase's start{note} [{card}]", flush=True)
    return objective, ckpt


def xvector_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 22."""
    family_run(card, tmp, "speaker_xvector", wav_dir, trials, shards)
    print(f"speaker_xvector {family_f32_step('speaker_xvector')} [{card}]", flush=True)


def ecapa_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 23: the ECAPA run, its f32 step, then the predict twin on the
    run's best checkpoint."""
    _, ckpt = family_run(card, tmp, "speaker_ecapa_tdnn", wav_dir, trials, shards)
    print(f"speaker_ecapa_tdnn {family_f32_step('speaker_ecapa_tdnn')} [{card}]", flush=True)
    family_predict(card, tmp, "speaker_ecapa_tdnn", ["network=ecapa_tdnn", "optim/loss=aam_softmax"], ckpt)


def family_predict(card: str, tmp: pathlib.Path, label: str, network, ckpt) -> None:
    """The predict twin with ``network``'s overrides (float32) on the
    checkpoint ``ckpt / "best"`` over 6 of phase 12's files in buckets:
    one score in [0, 1] per pair, no kernel launched, the scores against
    ``extract_embeddings`` + cosine on the same model, the bucketed
    embeddings against each file alone (``padding_ratio``)."""
    rng = np.random.default_rng(12)  # phase 12's draws: its first files
    seconds = np.round(rng.uniform(2.0, 30.0, PREDICT_FILES), 2)[:FAMILY_PREDICT_FILES]
    folder = tmp / f"{label}_predict"
    ids = list(write_predict_folder(folder, seconds, PREDICT_SPEAKERS, rng))
    pair_file = folder / "pairs.txt"
    pair_file.write_text("".join(f"{a} {b}\n" for i, a in enumerate(ids) for b in ids[i + 1:]))
    overrides = [*network, "trainer.precision=f32",
                 f"load_network_from_checkpoint={ckpt / 'best'}", f"data.dataloader.test_pad_to_multiple={PREDICT_PAD}",
                 f"data.dataloader.test_batch_size={PREDICT_BATCH}", f"predict_folder_path={folder}",
                 f"pair_prediction_path={pair_file}"]
    reset_launches()
    t0 = time.perf_counter()
    scores, pairs = read_scores(predict.main(overrides))
    predict_s = time.perf_counter() - t0
    assert sum(launches().values()) == 0, f"{label} predict launched {launches()}"
    assert len(pairs) == len(ids) * (len(ids) - 1) // 2 and np.all((scores >= 0) & (scores <= 1)), \
        f"{label} predict: scores {scores}"
    model = build_predict_model(load_config(predict.CONFIG_DIR, "predict", overrides))
    samples = [SpeakerSample(rel, normalize_waveform(load_raw_audio(folder / rel))) for rel in ids]
    served = {e.sample_id: e.embedding for e in extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH)}
    same = float(np.abs(cosine_scores(served, pairs) - scores).max())
    ratio = padding_ratio(served, unpadded_embeddings(embed, model, samples))
    assert same <= PREDICT_SAME_ATOL and ratio <= MAX_PAD_RATIO, f"{label} predict: {same}, ratio {ratio}"
    print(f"{label} predict twin on the best checkpoint: {len(ids)} files of "
          f"{seconds.min()}-{seconds.max()} s in buckets of {PREDICT_PAD}, batch {PREDICT_BATCH}, {len(pairs)} pairs "
          f"in {predict_s:.2f} s; written vs extract_embeddings + cosine max diff {same:.3e}; bucketed vs "
          f"unpadded batch-1 distance ratio {ratio:.3e} (limit {MAX_PAD_RATIO}); launches 0 [{card}]", flush=True)


def wav2spk_dummy_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 24: wav2spk under the multi-step schedule, then the dummy
    recipe under its debug trainer."""
    algo, sched = (load_recipe("speaker_wav2spk")["optim"][k] for k in ("algo", "schedule"))
    lrs, update = [], AdamTx.update
    AdamTx.update = lambda tx, named: (update(tx, named), lrs.append(tx.adam.param_groups[0]["lr"]))[0]
    try:
        family_run(card, tmp, "speaker_wav2spk", wav_dir, trials, shards,
                   extra=[f"optim.schedule.milestones=[{','.join(map(str, WAV2SPK_MILESTONES))}]"])
    finally:
        AdamTx.update = update
    want = [multi_step_decay(algo["lr"], WAV2SPK_MILESTONES, sched["gamma"])(i) for i in range(FAMILY_STEPS)]
    assert lrs == want and want[0] > want[2] > want[3], f"wav2spk learning rates {lrs}, multi_step_decay {want}"
    print(f"speaker_wav2spk learning rate per step {lrs} (multi_step_decay, milestones {WAV2SPK_MILESTONES}, "
          f"gamma {sched['gamma']}: {want}); {family_f32_step('speaker_wav2spk')} [{card}]", flush=True)
    family_run(card, tmp, "speaker_dummy", wav_dir, trials, shards,
               steps=load_recipe("speaker_dummy")["trainer"]["max_steps"], trainer=[])


# phases 25-28 (the augmented input path, the debug surface, wav2vec v1). The
# native DSP library against scipy: tests/test_native.py's limits
DSP_UPFIRDN_TOL, DSP_FIR_TOL, DSP_FFT_TOL, DSP_SPEED_TOL = (1e-4, 1e-6), (1e-4, 1e-6), (2e-4, 2e-4), (1e-3, 1e-5)
AUGMENT_PIPELINES = ("xvector_all_augment_pipeline", "xvector_dropout_augment_pipeline", "xvector_rirs_augment")
PIPELINE_WORKERS = (1, 4)
RIRS_SHARDS, RIRS_PER_SHARD = 2, 8  # synthetic pointsource_noises shards: bursts of 0.5-2 s
V1_NETWORKS = (  # (label, overrides of speaker_wav2vec2_ce), float32 at the networks' published width
    ("wav2vec_fc", ["network=wav2vec_fc"]),
    ("wav2vec_fc_meanstd_agg", ["network=wav2vec_fc", "network.stat_pooling_type=mean+std",
                                "network.use_aggregation_layers=true"]),
    ("wav2vec_xvector", ["network=wav2vec_xvector"]),
)
V1_F32_CHECKED = ("wav2vec_fc_meanstd_agg", "wav2vec_xvector")  # the f32 step against float64 (the fc's superset)


def dsp_phase(card: str) -> None:
    """Phase 25: ``native/dsp.cpp`` built by ``utils/native.py`` on this
    machine, each entry point held against scipy (and timed beside it on
    a 5 s clip, host ms)."""
    from scipy import signal

    from w2v2_speaker_tpu_torch.data import augment
    from w2v2_speaker_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(25)
    x = rng.normal(size=80000).astype(np.float32)
    taps = signal.firwin(41, 0.3).astype(np.float32)
    band = signal.firwin(255, [0.1, 0.4], pass_zero=True).astype(np.float32)
    h = rng.normal(size=12000).astype(np.float32)
    frac = augment.Fraction(1.0 / 0.95).limit_denominator(100)
    cases = {  # name: (native call, scipy call, (rtol, atol))
        "upfirdn 20/21": (lambda: native.upfirdn(x, taps, 20, 21),
                          lambda: signal.upfirdn(taps.astype(np.float64), x.astype(np.float64), 20, 21), DSP_UPFIRDN_TOL),
        "fir_same 255": (lambda: native.fir_same(x, band), lambda: signal.fftconvolve(x, band, mode="same"), DSP_FIR_TOL),
        "fft_convolve 12000": (lambda: native.fft_convolve(x, h), lambda: signal.fftconvolve(x, h), DSP_FFT_TOL),
        "speed 0.95": (lambda: augment.speed_perturb_native(x, frac.numerator, frac.denominator),
                       lambda: signal.resample_poly(x, frac.numerator, frac.denominator).astype(np.float32),
                       DSP_SPEED_TOL),
    }
    report = []
    for name, (ours, theirs, (rtol, atol)) in cases.items():
        got, want = ours(), theirs()
        assert got.shape == want.shape, f"dsp {name}: {got.shape} vs {want.shape}"
        excess = float((np.abs(got - want) - (atol + rtol * np.abs(want))).max())
        assert excess <= 0, f"dsp {name}: {excess} over rtol {rtol}, atol {atol}"
        times = []
        for fn in (ours, theirs):
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / 5)
        report.append(f"{name} max err {float(np.abs(got - want).max()):.2e} (rtol {rtol}, atol {atol}), "
                      f"{times[0]:.2f} ms vs scipy {times[1]:.2f}")
    print(f"native DSP library {native.library_path().name} built in {build_s:.2f} s; on a 5 s clip (host): "
          + "; ".join(report) + f" [{card}]", flush=True)


def write_noise_shards(root: pathlib.Path, rng) -> pathlib.Path:
    """``pointsource_noises-NNNNNN.tar`` shards of noise bursts of 0.5-2 s
    (shorter than the 3.5-5 s utterances, so the RIRS effect tiles them)."""
    from w2v2_speaker_tpu_torch.data.shards import ShardWriter

    root.mkdir(parents=True, exist_ok=True)
    for i in range(RIRS_SHARDS):
        with ShardWriter(root / f"pointsource_noises-{i:06d}.tar") as w:
            for j in range(RIRS_PER_SHARD):
                burst = rng.normal(0, 0.1, int(rng.uniform(0.5, 2.0) * 16000)).astype(np.float32)
                w.write(f"noise/{i}/{j}", burst, {"sampling_rate": 16000})
    return root


def host_pipeline_ms(overrides) -> dict:
    """{workers: (host ms per batch over one training epoch of the data
    module of ``overrides``, batches)} at each of ``PIPELINE_WORKERS``:
    the pipeline's own pace, queue fill included, without a step."""
    from w2v2_speaker_tpu_torch.runtime.experiment import build_data_module

    out = {}
    for workers in PIPELINE_WORKERS:
        dm = build_data_module(load_recipe("speaker_xvector", [*overrides,
                                                               f"data.dataloader.num_pipeline_workers={workers}"]))
        t0 = time.perf_counter()
        n = sum(1 for _ in dm.train_batches())
        out[workers] = (1e3 * (time.perf_counter() - t0) / n, n)
    return out


def augment_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 26: the x-vector augmentation study at full width: ``run.main``
    on ``speaker_xvector`` (f32, B=66 x 3 s, 4 steps in one dispatch) with
    each augment pipeline over phase 13's shards, the RIRS one reading
    synthetic ``pointsource_noises`` shards; beside each run's ms/step, the
    host pipeline's ms per batch at 1 and 4 workers."""
    write_noise_shards(tmp / "rirs_shards", np.random.default_rng(26))
    for pipeline in AUGMENT_PIPELINES:
        extra = [f"data/pipeline={pipeline}", f"data_folder={tmp}"]
        host = host_pipeline_ms([*extra, f"data.shards.samples_per_shard={RUN_SHARD}",
                                 *corpus_args(wav_dir, trials, shards, tmp / "unused_ckpt")])
        family_run(card, tmp, "speaker_xvector", wav_dir, trials, shards, extra=extra, label=f"xvector_{pipeline}",
                   note="; host pipeline ms per batch over an epoch (queue fill included) " + ", ".join(
                       f"{w} worker(s) {ms:.1f} ({n} batches)" for w, (ms, n) in host.items()))


def augmented_base_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phases 27 (c) and (d): ``run.main`` on ``speaker_wav2vec2_ce`` at full
    BASE width (bf16, B=66) with ``xvector_dropout_augment_pipeline``,
    ``trainer.dump_first_batch=true`` and ``verify_model=true``, 4 steps in
    one dispatch: launches = kept layers in every step, finite losses, the
    attention kernels held at a training batch's own q/k/v, the leakage
    probe passed on the card, the dump's artifact tree."""
    import contextlib
    import io

    from w2v2_speaker_tpu_torch import run

    out_dir = tmp / "augmented_base"
    argv = ["+experiment=speaker_wav2vec2_ce", "data/pipeline=xvector_dropout_augment_pipeline",
            f"data.shards.samples_per_shard={RUN_SHARD}", "trainer.max_steps=4", "trainer.val_check_interval=4",
            "trainer.dump_first_batch=true", "verify_model=true", "seed=27",
            *corpus_args(wav_dir, trials, shards, out_dir / "ckpt")]
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with RunProbe() as probe, contextlib.redirect_stdout(printed):
        objective = run.main(argv)
    run_s = time.perf_counter() - t0
    sys.stdout.write(printed.getvalue()[-3000:])
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    kept = check_steps("augmented BASE run", probe, 4)
    assert all(v > 0 for k, v in launches().items() if k in ATTENTION), f"augmented BASE run: launches {launches()}"
    assert objective is not None and 0 <= objective <= 1, f"augmented BASE run: objective {objective}"
    assert "batch gradient verification: no cross-batch leakage" in printed.getvalue(), "verify_model did not pass"
    attention, _, _ = check_run_attention(probe.attn)
    first = out_dir / "first_batch"
    keys = eval((first / "batch_keys.txt").read_text())
    feats = np.load(first / "batch_features.npy")
    samples = sorted(p for p in (first / "per_sample").iterdir() if p.is_dir())
    stages = [p.stem for p in sorted(samples[0].glob("*.npy"))]
    assert feats.shape == (66, 48000) and len(keys) == 66 and len(samples) == 4, \
        f"dump: {feats.shape}, {len(keys)} keys, {len(samples)} samples"
    assert stages[:4] == ["00_original", "01_augment_time_dropout", "02_augment_frequency_dropout",
                          "03_augment_choice_speed"] and all(
        (d / f"{s}.{ext}").exists() for d in samples for s in [p.stem for p in d.glob("*.npy")]
        for ext in ("txt", "wav")), f"dump stages {stages}"
    effects = sorted({k.split("/", 3)[3] if k.count("/") == 3 else "" for k in keys})
    print(f"augmented BASE run (xvector_dropout_augment_pipeline, bf16 B=66 x 48000): losses "
          f"{[round(m['loss'], 4) for _, m in probe.steps]}; {probe.step_ms(1, 2):.3f} ms/step (steps 2-3); host "
          f"wait per batch {[round(1e3 * w, 1) for w in probe.waits]} ms; launches per step = layers kept {kept}; "
          f"kernels vs plain on a training batch: {attention}; verify_model: summary and no cross-batch leakage "
          f"on the card; first batch {feats.shape} with effects {effects}, {len(samples)} samples' stages "
          f"{stages}; objective {objective:.4f}; whole run {run_s:.2f} s; peak {peak_gib:.2f} GiB [{card}]",
          flush=True)


def wav2vec1_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 28: wav2vec v1 at its published width (512 x 5 strided convs,
    the 9-layer aggregator where asked), float32, B=66 x 3 s: ``run.main``
    (4 steps) and the predict twin on each run's best checkpoint, and for
    ``V1_F32_CHECKED`` the f32 step card vs CPU against a float64 step."""
    for label, overrides in V1_NETWORKS:
        _, ckpt = family_run(card, tmp, "speaker_wav2vec2_ce", wav_dir, trials, shards,
                             extra=[*overrides, "trainer.precision=f32"], label=label)
        family_predict(card, tmp, label, overrides, ckpt)
        if label in V1_F32_CHECKED:
            report = family_f32_step("speaker_wav2vec2_ce", [*overrides, "trainer.precision=f32"], label)
            print(f"{label} {report} [{card}]", flush=True)


class RateProbe:
    """For the length of a ``with`` block, records every update of
    ``AdamTx`` and ``SgdTx``: (the transform's count, its schedule's rate
    there, the rate its torch optimizer held after the update, None for
    the bf16-moment update, which has none)."""

    def __enter__(self):
        self.rates, self._saved = [], []
        for cls in (AdamTx, SgdTx):
            orig = cls.update

            def update(tx, named, orig=orig):
                count, rate = tx.count, tx.schedule(tx.count)
                orig(tx, named)
                opt = getattr(tx, "adam", None) or getattr(tx, "sgd", None)
                self.rates.append((count, rate, None if opt is None else opt.param_groups[0]["lr"]))

            self._saved.append((cls, orig))
            cls.update = update
        return self

    def __exit__(self, *exc):
        for cls, orig in self._saved:
            cls.update = orig


def captured(fn, *args, tail: int = 2500, **kwargs):
    """(fn's result, what it printed); the last ``tail`` characters are
    passed on to the log."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    sys.stdout.write(out.getvalue()[-tail:])
    return result, out.getvalue()


def free_checkpoints(tmp: pathlib.Path) -> None:
    """Delete the checkpoint directories that finished phases left under
    ``tmp``, but phase 13's (phase 34 serves its best). The card machine's
    disk keeps the largest amount ever written to it at once, and a BASE
    checkpoint is ~1.1 GiB: freed space is written again, not added."""
    import shutil

    for path in sorted(tmp.rglob("*ckpt*")):
        if path.is_dir() and path != tmp / "ckpt" and path.exists():
            shutil.rmtree(path)


def fresh_phase() -> int:
    """Frees what earlier runs left; returns the bytes still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    return torch.cuda.memory_allocated()


def find_state(tree, key):
    """The first value under ``key`` in a nested checkpoint dict."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for v in tree.values():
            found = find_state(v, key)
            if found is not None:
                return found
    return None


def optim_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 29 (a)-(c): ``run.main`` on ``speaker_wav2vec2_ce`` at full BASE
    width (bf16, B=66) on phase 13's shards under each of ``OPTIM_RUNS``,
    ``OPTIM_STEPS`` steps (6 under reduce-on-plateau, with a validation
    after each): every update's rate equal to the port's schedule
    function (for reduce-on-plateau, the controller replayed on the logged
    validation EERs, and the last checkpoint holding its state) and held by
    the torch optimizer, finite losses, launches = kept layers, ms/step."""
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.objectives import schedules

    lr = load_recipe("speaker_wav2vec2_ce")["optim"]["algo"]["lr"]
    for i, (label, overrides) in enumerate(OPTIM_RUNS):
        ckpt = tmp / f"optim{i}" / "ckpt"
        cfg = load_recipe("speaker_wav2vec2_ce", [f"trainer.max_steps={OPTIM_STEPS}", *overrides])
        steps = cfg["trainer"]["max_steps"]
        held = fresh_phase()
        t0 = time.perf_counter()
        with RunProbe() as probe, RateProbe() as rates:
            objective, _ = captured(run.main, [
                "+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}",
                f"trainer.max_steps={OPTIM_STEPS}", "trainer.val_check_interval=2", "seed=29",
                *corpus_args(wav_dir, trials, shards, ckpt), *overrides])
        run_s = time.perf_counter() - t0
        kept = check_steps(label, probe, steps)
        sched = cfg["optim"]["schedule"]
        val = [(s, m["val_eer"]) for s, m in probe.evals if "val_eer" in m]
        if sched["name"] == "reduce_on_plateau":
            ctl, factors = schedules.ReduceLROnPlateauController(factor=sched["factor"], patience=sched["patience"]), []
            for count in range(steps):
                for s, metric in val:
                    if s == count:  # the validation after step `count` sets the rate of update `count`
                        ctl.update(metric)
                factors.append(ctl.factor_value)
            for s, metric in val:
                if s == steps:
                    ctl.update(metric)
            want = [float(np.float32(lr * f)) for f in factors]
            saved = find_state(torch.load(ckpt / "last" / "state.pt", map_location="cpu", weights_only=True)["tx"],
                               "schedule")
            assert saved == ctl.state_dict(), f"{label}: checkpointed controller {saved}, replayed {ctl.state_dict()}"
        elif sched["name"] == "cyclic":
            fn = schedules.cyclic(sched["base_lr"], sched["max_lr"], sched["step_size_up"], sched.get("step_size_down"))
            want = [fn(c) for c in range(steps)]
        else:
            fn = schedules.exp_decay(steps, lr, sched["final_lr"])
            want = [fn(c) for c in range(steps)]
        got = [rate for _, rate, _ in rates.rates]
        assert [c for c, _, _ in rates.rates] == list(range(steps)) and got == want, \
            f"{label}: rates {rates.rates}, want {want}"
        assert all(opt == rate for _, rate, opt in rates.rates), f"{label}: optimizer rates {rates.rates}"
        assert objective is not None and 0 <= objective <= 1, f"{label}: objective {objective}"
        spans = probe.spans_ms(1, steps - 1)
        print(f"optimizers {label} (BASE bf16 B=66 x 48000): rates {got} (= the schedule; for reduce_on_plateau "
              f"the controller replayed on val EERs {[(s, round(m, 4)) for s, m in val]}); losses "
              f"{[round(m['loss'], 4) for _, m in probe.steps]}; {np.mean(spans):.3f} ms/step (CUDA events, each "
              f"of steps 2-{steps}: {[round(x, 2) for x in spans]}); launches per step = layers kept {kept}; "
              f"test EER {objective:.4f}; whole run {run_s:.2f} s; peak "
              f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB [{card}]", flush=True)


def _inner_adam(tx) -> AdamTx:
    while not isinstance(tx, AdamTx):
        tx = tx.inner
    return tx


def _moments(adam: AdamTx, params) -> tuple:
    """(first moments, second moments) of ``params``, in parameter order."""
    if adam.adam is None:
        return adam.mu, adam.nu
    st = adam.adam.state
    return [st[p]["exp_avg"] for p in params], [st[p]["exp_avg_sq"] for p in params]


def mu_dtype_phase(card: str) -> None:
    """Phase 29 (d): the LARGE AAM recipe on the fused conv, bf16, B=48:
    one training step from one state (after one warm-up step that fills
    the moments) with float32 first moments and with
    ``optim.algo.mu_dtype=bfloat16``. Prints the first moment's dtype, the
    optimizer state's bytes, the step's peak memory and time, and holds the
    updated parameters (within ``MU_PARAM_ULPS``) and the stored bf16
    moments (bit for bit) against a plain per-tensor float32 recompute of
    the rule from the same gradients: optax's for the bf16 store (b1
    rounded to bf16 times the stored moment, rounded, plus (1 - b1) g in
    float32; that float32 moment into the update with float32 bias
    corrections; then the cast), torch's Adam in its own grouping for
    float32 moments; 6 conv and kept-layer attention launches."""
    dev = torch.device("cuda")
    batch = {k: v[0] for k, v in synthetic_batch(LARGE_BATCH, SAMPLES, dev, seed=29).items()}
    for mu_dtype in (None, "bfloat16"):
        cfg = load_recipe("speaker_wav2vec2_large_aam",
                          ["network.conv_impl=fused_pallas", *([f"optim.algo.mu_dtype={mu_dtype}"] if mu_dtype else [])])
        fresh_phase()
        state, task = build_train_state(dev, "bf16", cfg, seed=0)
        step = make_train_step(task)
        state, _ = step(state, batch)  # warm-up: the moments hold one step
        adam = _inner_adam(state.tx)
        params = [p for _, p in state.named_params()]
        mu, nu = _moments(adam, params)
        before = [(p.detach().clone(), m.clone(), v.clone()) for p, m, v in zip(params, mu, nu)]
        state_bytes = sum(t.numel() * t.element_size() for t in [*mu, *nu])
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        ms, peak = start.elapsed_time(stop), (torch.cuda.max_memory_allocated() - held) / 2**30
        kept = int(metrics["layers_run"])
        fwd = kept * (2 if state.model.wav2vec2.encoder.remat else 1)  # the recipe's remat recomputes the forward
        assert launches() == {**{k: kept for k in ATTENTION}, "flash_attention_fwd": fwd, "conv_encoder": 6}, \
            f"29d {mu_dtype}: kept {kept}, launched {launches()}"
        b1, b2 = adam.betas
        n = adam.count
        lr = adam.schedule(n - 1)
        if mu_dtype:  # optax's bias corrections, in float32
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
        else:  # torch's, in float64
            bc1, bc2 = 1 - b1 ** n, 1 - b2 ** n
        mu, nu = _moments(adam, params)
        worst_ulps, mu_differ = 0.0, 0
        with torch.no_grad():
            for p, m_new, (p0, m0, v0) in zip(params, mu, before):
                g = p.grad.float()
                if mu_dtype:  # optax's scale_by_adam with the bf16 store
                    m32 = (1 - b1) * g + (m0 * float(torch.tensor(b1, dtype=m0.dtype))).float()
                    v32 = (1 - b2) * (g * g) + b2 * v0
                    want = p0 + (-lr) * ((m32 / bc1) / ((v32 / bc2).sqrt() + adam.eps))
                else:  # torch.optim.Adam's grouping of the same rule
                    m32 = m0.lerp(g, 1 - b1)
                    v32 = (v0 * b2).addcmul(g, g, value=1 - b2)
                    want = p0.addcdiv(m32, (v32.sqrt() / bc2 ** 0.5).add(adam.eps), value=-lr / bc1)
                scale = torch.maximum(p0.abs(), want.abs())
                ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
                worst_ulps = max(worst_ulps, float(((p - want).abs() / ulp).max()))
                if mu_dtype:
                    mu_differ += int((m_new != m32.to(m_new.dtype)).sum())
        assert worst_ulps <= MU_PARAM_ULPS and mu_differ == 0, \
            f"29d {mu_dtype}: parameters {worst_ulps} ulps from the recompute, {mu_differ} stored moments differ"
        assert torch.isfinite(metrics["loss"]), f"29d {mu_dtype}: loss {metrics['loss']}"
        print(f"LARGE AAM fused conv bf16 B={LARGE_BATCH} x {SAMPLES}, first moment {mu[0].dtype}: optimizer state "
              f"{state_bytes / 2**30:.3f} GiB (first + second moments of {sum(p.numel() for p in params)} "
              f"parameters); step {ms:.3f} ms (CUDA events, one step after a warm-up step), peak {peak:.2f} GiB above "
              f"the {held / 2**30:.2f} GiB held; launches {launches()} (kept {kept}); updated parameters at most "
              f"{worst_ulps:.0f} float32 ulps from the plain float32 recompute (limit {MU_PARAM_ULPS})"
              + (f", stored bf16 moments bit-equal to the recompute's ({mu_differ} differ)" if mu_dtype else "")
              + f"; loss {float(metrics['loss']):.4f} [{card}]", flush=True)
        del state, task, step, before, params, mu, nu, adam


def lr_find_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 30: ``run.main`` with ``run_lr_range_test=true`` and
    ``tune_iterations=LR_ITERATIONS`` on ``speaker_wav2vec2_ce`` at full
    BASE width (bf16, B=66) on phase 13's shards: ``data.json`` with
    ``lr``, ``loss`` and ``suggestion``, the rate of every step the float32
    table's entry (the JSON the float64 rates), the suggestion one of the
    rates, launches = kept layers in every step, ms/step."""
    from w2v2_speaker_tpu_torch import run

    out = tmp / "lr_find"
    kept = []
    loss_fn = SpeakerTask.loss_fn

    def recorded(task, *a, **kw):
        loss, aux = loss_fn(task, *a, **kw)
        kept.append(int(aux["metrics"]["layers_run"]))
        return loss, aux

    held = fresh_phase()
    t0 = time.perf_counter()
    SpeakerTask.loss_fn = recorded
    try:
        with RunProbe() as probe, RateProbe() as rates:
            suggestion, _ = captured(run.main, [
                "+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}",
                "run_lr_range_test=true", f"tune_iterations={LR_ITERATIONS}", "seed=30",
                *corpus_args(wav_dir, trials, shards, out / "ckpt")])
    finally:
        SpeakerTask.loss_fn = loss_fn
    run_s = time.perf_counter() - t0
    data = json.loads((out / "auto_lr_find" / "data.json").read_text())
    table = np.exp(np.linspace(np.log(1e-8), np.log(1.0), LR_ITERATIONS))
    steps = len(data["loss"])
    assert sorted(data) == ["loss", "lr", "suggestion"] and data["lr"] == table[:steps].tolist(), f"lr test: {data}"
    assert [r for _, r, _ in rates.rates] == [float(np.float32(x)) for x in table[:steps]], f"rates {rates.rates}"
    assert all(opt == r for _, r, opt in rates.rates) and len(kept) == steps == len(probe.ends) >= 4
    assert suggestion == data["suggestion"] and suggestion in data["lr"], f"suggestion {suggestion}"
    per_step = [{k: e[1][k] - s[1][k] for k in e[1]} for s, e in zip(probe.starts, probe.ends)]
    for layers, got in zip(kept, per_step, strict=True):
        assert got == {**{k: layers for k in ATTENTION}, "conv_encoder": 0}, f"lr test: kept {layers}, {got}"
    assert all(np.isfinite(x) for x in data["loss"][:-1]), f"lr test losses {data['loss']}"
    spans = probe.spans_ms(1, steps - 1)
    print(f"LR range test (BASE bf16 B=66 x 48000): {steps} of {LR_ITERATIONS} steps (the divergence stop ends "
          f"it where the smoothed loss passes 4x its best), rates = the float32 table, suggestion "
          f"{suggestion:.3e}; smoothed losses {[round(x, 3) for x in data['loss']]}; {np.mean(spans):.3f} ms/step "
          f"(CUDA events, each of steps 2-{steps}); launches per step = layers kept {kept}; whole run {run_s:.2f} s; "
          f"peak {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB [{card}]", flush=True)


def tracker_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 31: ``callbacks=speaker_progress_tracker`` under ``run.main``
    on ``speaker_wav2vec2_ce`` at full BASE width (bf16, B=66) and on
    ``speaker_xvector`` (float32), 4 steps with validations at 2 and 4, on
    phase 13's shards: one snapshot per validation, its ``embeddings.npy``
    of shape [5 speakers x 2, D] equal to the embed path
    (``compute_embedding``) on the same model and probe batch within
    ``SNAPSHOT_ATOL``, its separation metrics logged beside ``val_eer`` and
    finite; the BASE snapshot launches the attention forward once per
    layer, the training steps launch as phase 13's."""
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.runtime.experiment import _embed_batch
    from w2v2_speaker_tpu_torch.runtime.progress import ProgressTracker

    for recipe, layers in (("speaker_wav2vec2_ce", BASE_CONFIG.num_layers), ("speaker_xvector", 0)):
        out = tmp / f"tracked_{recipe}"
        snaps = []
        snapshot = ProgressTracker.snapshot

        def recorded(tracker, step, embed_fn):
            before = launches()
            metrics = snapshot(tracker, step, embed_fn)
            got = {k: n - before[k] for k, n in launches().items()}
            saved = np.load(tracker.out_dir / f"step_{int(step):08d}" / "embeddings.npy")
            direct = _embed_batch(probe.task.model, {"features": tracker.features, "mask": tracker.mask},
                                  torch.device("cuda"))
            snaps.append((int(step), saved.shape, float(np.abs(saved - direct).max()), got, metrics))
            return metrics

        held = fresh_phase()
        t0 = time.perf_counter()
        ProgressTracker.snapshot = recorded
        try:
            with RunProbe() as probe:
                objective, _ = captured(run.main, [
                    f"+experiment={recipe}", f"data.shards.samples_per_shard={RUN_SHARD}", "trainer.max_steps=4",
                    "trainer.val_check_interval=2", "callbacks=speaker_progress_tracker", "seed=31",
                    *corpus_args(wav_dir, trials, shards, out / "ckpt")])
        finally:
            ProgressTracker.snapshot = snapshot
        run_s = time.perf_counter() - t0
        assert [s for s, _, _, _, _ in snaps] == [2, 4], f"{recipe}: snapshots {snaps}"
        assert sorted(p.name for p in (out / "progress").iterdir()) == ["step_00000002", "step_00000004"]
        for step, shape, err, got, metrics in snaps:
            assert shape[0] == 10 and err <= SNAPSHOT_ATOL, f"{recipe} step {step}: {shape}, err {err}"
            assert got == {**{k: 0 for k in launches()}, "flash_attention_fwd": layers}, f"{recipe}: launched {got}"
            logged = [m for s, m in probe.evals if s == step and "val_eer" in m][0]
            assert all(np.isfinite(logged[k]) and logged[k] == v for k, v in metrics.items()) and len(metrics) == 3, \
                f"{recipe} step {step}: {metrics} vs logged {logged}"
        if layers:
            kept = check_steps(recipe, probe, 4)
        else:
            assert all(got == {k: 0 for k in launches()} for _, _, got in probe.per_step()), f"{recipe}: launches"
            kept = None
        print(f"progress tracker on {recipe} ({'BASE bf16 B=66' if layers else 'float32 B=66'}): snapshots at steps "
              f"{[s for s, *_ in snaps]} of shape {snaps[0][1]}, max |snapshot - compute_embedding on the same model "
              f"and probe batch| {[s[2] for s in snaps]} (limit {SNAPSHOT_ATOL}); separation metrics "
              f"{[{k: round(v, 5) for k, v in s[4].items()} for s in snaps]}; snapshot launches {snaps[0][3]}; "
              f"training launches per step = layers kept {kept}; test EER {objective:.4f}; whole run {run_s:.2f} s; "
              f"peak {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB [{card}]", flush=True)


def surface_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 32: the run twin's surface at full BASE width (bf16, B=66) on
    phase 13's shards, 2 steps a run: a ``-m network.stat_pooling_type=mean,max``
    grid (two objectives, two checkpoint directories, launches = kept
    layers); ``-m +search=lr_and_pooling`` with ``SEARCH_TRIALS`` trials
    (every trial's overrides those of the port's sampler replayed with the
    logged objectives, the best printed, each trial's memory at its
    start); ``hydra/launcher=slurm`` on a 2-point grid (the array script
    written, the card machine having no ``sbatch``, its tasks running
    ``-m w2v2_speaker_tpu_torch.run`` with ``job<i>`` checkpoint
    directories); ``-sc`` of both twins. The memory held at each trial's
    start must not grow from the second trial on."""
    import ast
    import re

    import yaml

    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.runtime.sweeper import TPESampler, format_override

    common = ["+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}", "trainer.max_steps=2",
              "trainer.val_check_interval=2", "trainer.num_sanity_val_steps=0", "seed=32"]
    held = fresh_phase()
    t0 = time.perf_counter()
    with RunProbe() as probe:
        best, printed = captured(run.main, ["-m", *common, *corpus_args(wav_dir, trials, shards, tmp / "grid"),
                                            "network.stat_pooling_type=mean,max"])
    grid_s = time.perf_counter() - t0
    summary = printed.split("=== multirun summary (sorted by objective)")[1].splitlines()[1:3]
    objectives = [float(line.split()[0]) for line in summary]
    assert abs(best - min(objectives)) < 1e-5, f"grid: {summary}"  # the summary prints 5 decimals
    assert all(0 <= o <= 1 for o in objectives), f"grid: {summary}"
    for job in ("job0", "job1"):
        index = json.loads((tmp / "grid" / job / "index.json").read_text())
        assert index["last"]["step"] == 2, f"grid {job}: {index}"
    assert [s for s, _ in probe.steps] == [1, 2, 1, 2], f"grid steps {probe.steps}"
    for _, layers, got in probe.per_step():
        assert got == {**{k: layers for k in ATTENTION}, "conv_encoder": 0}, f"grid: kept {layers}, {got}"

    t0 = time.perf_counter()
    with RunProbe() as probe:
        best, printed = captured(run.main, ["-m", *common, *corpus_args(wav_dir, trials, shards, tmp / "search"),
                                            "+search=lr_and_pooling", f"search.n_trials={SEARCH_TRIALS}",
                                            "search.n_startup_trials=2"], tail=4000)
    search_s = time.perf_counter() - t0
    space = yaml.safe_load((CONFIG_DIR / "search" / "lr_and_pooling.yaml").read_text())["search"]
    sampler = TPESampler(space["search_space"], seed=space["seed"], n_startup_trials=2)
    asked = [ast.literal_eval(m) for m in re.findall(r"=== search trial \d+/\d+ \[lr_and_pooling\]: (\[.*\])", printed)]
    told = dict((int(i), float(v)) for i, v in re.findall(r"trial (\d+) objective: (\S+)", printed))
    assert len(asked) == SEARCH_TRIALS and told, f"search: asked {asked}, told {told}"
    for i, overrides in enumerate(asked):
        params = sampler.ask()
        assert [format_override(k, v) for k, v in params.items()] == overrides, f"trial {i}: {overrides} vs {params}"
        if i in told:
            sampler.tell(params, told[i])
    assert best == sampler.best[1] and f"=== search [lr_and_pooling] best objective: {best}" in printed
    memory = [float(m) for m in re.findall(r"trial \d+: (\S+) MiB allocated on the card at its start", printed)]
    # from the second trial on, the memory held at a trial's start includes
    # the first trial's model, which the probe keeps for its hooks; it must
    # not grow from trial to trial
    assert len(memory) == SEARCH_TRIALS and max(memory[1:]) - min(memory[1:]) < 64, f"search: memory {memory}"
    for _, layers, got in probe.per_step():
        assert got == {**{k: layers for k in ATTENTION}, "conv_encoder": 0}, f"search: kept {layers}, {got}"

    _, printed = captured(run.main, ["-m", "hydra/launcher=slurm", *common,
                                     *corpus_args(wav_dir, trials, shards, tmp / "slurm"),
                                     "network.stat_pooling_type=mean,max"])
    script = (tmp / "slurm" / ".slurm" / "sweep.sbatch").read_text()
    tasks = [line for line in script.splitlines() if line.startswith("  ")]
    assert "sbatch not found" in printed and len(tasks) == 2, f"launcher: {printed[-500:]}"
    assert all("-m w2v2_speaker_tpu_torch.run" in t and f"/job{i}" in t for i, t in enumerate(tasks)), tasks
    assert not (tmp / "slurm" / "job0").exists()
    completions = [captured(twin.main, ["-sc", f"query={word}"])[1].split()
                   for twin, word in ((run, "network.stat"), (predict, "network="))]
    assert all(completions), f"-sc: {completions}"
    print(f"run surface (BASE bf16 B=66 x 48000, 2 steps a run): grid objectives {objectives} (mean, max pooling), "
          f"{grid_s:.2f} s; search of {SEARCH_TRIALS} trials "
          f"{asked} with objectives {told} = the sampler replayed, best {sampler.best[1]:.4f}, memory at each "
          f"trial's start {memory} MiB (from the second on, the probe's hold on the first trial's model), "
          f"{search_s:.2f} s; SLURM array of {len(tasks)} tasks written (no sbatch); "
          f"-sc candidates {completions[0][:3]} / {completions[1][:3]}; peak "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB [{card}]", flush=True)


# phases 33-35 (slice 12): int8 serving and the TPU-era run knobs. The int8
# kernels against their plain versions bit for bit (the int32 sums are exact,
# the epilogue's float32 order fixed); the dense sites (N, K) of LARGE
# (projection, qkv, out, intermediate, output) at M from phase 12's longest
# bucket batch, of BASE at B=48 x 3 s, and a ragged M, N, K (K not a multiple
# of 16: padded by the wrapper)
INT8_LARGE_SITES = ((1024, 512), (3072, 1024), (1024, 1024), (4096, 1024), (1024, 4096))
INT8_BASE_SITES = ((768, 512), (2304, 768), (768, 768), (3072, 768), (768, 3072))
INT8_RAGGED = (1001, 777, 200)
INT8_BASE_BATCH = 48
PEAK_INT8 = 1979e12  # H100 SXM int8 dense tensor-core rate (NVIDIA data sheet)
# int8 pair scores against bf16's on the (s + 1) / 2 scale: the JAX package's
# int8-vs-full-precision bar (tests/test_quant.py:117-118)
INT8_SCORE_ATOL = 0.02
INT8_GEMMS = 97  # LARGE: 24 layers x 4 dense sites + the feature projection
INT8_AUTO_S = (2.2, 2.5, 2.8, 3.0, 8.1, 8.4, 8.7, 9.0)  # BASE auto: bucket batches of 48 000 and 144 000 samples
INT8_CROSSOVER_S, INT8_CROSSOVER_BATCH = (3, 6, 12), 8  # config/data/dataloader's test_batch_size
DET_STEPS = 4
PROFILE_STEPS, PROFILE_WINDOW = 12, (10, 5)  # config/profiler/simple.yaml: start_step 10, num_steps 5
# a child process that runs the run twin on each (label, argv) of a JSON
# list, in turn (a JSON file it writes: per label, each logged loss as a
# float's hex, the device ms between consecutive steps' ends (CUDA events
# where each step's update returns), a SHA-256 of each final parameter's
# bytes; the CUBLAS_WORKSPACE_CONFIG it ran with)
RUN_CHILD = """
import hashlib, json, os, sys
import torch
from w2v2_speaker_tpu_torch import run
from w2v2_speaker_tpu_torch.runtime.logging import MetricsLogger
from w2v2_speaker_tpu_torch.train.state import TrainState
out, runs = sys.argv[1], json.load(open(sys.argv[2]))
log_step, apply = MetricsLogger.log_step, TrainState.apply_gradients
records = {}
for label, argv in runs:
    losses, ends, states = [], [], []
    def logged(self, step, m):
        losses.append(float(m["loss"]).hex())
        return log_step(self, step, m)
    def applied(self):
        result = apply(self)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        states[:] = [self]
        return result
    MetricsLogger.log_step, TrainState.apply_gradients = logged, applied
    run.main(argv)
    torch.cuda.synchronize()
    params = {n: hashlib.sha256(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
              for n, p in states[0].model.state_dict().items()}
    records[label] = {"losses": losses, "step_ms": [a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
                      "params": params}
json.dump({"runs": records, "cublas": os.environ.get("CUBLAS_WORKSPACE_CONFIG")}, open(out, "w"))
"""
# a child process that runs each (label, argv) of a JSON list under the run
# twin, in turn, and names the ones that trained
RECIPES_CHILD = """
import json, sys
from w2v2_speaker_tpu_torch import run
out, runs = sys.argv[1], json.load(open(sys.argv[2]))
done = []
for label, argv in runs:
    run.main(argv)
    done.append([label, "trained"])
    json.dump(done, open(out, "w"))
"""


def int8_inputs(m: int, n: int, k: int, gen) -> tuple:
    """A serving site's operands: bf16 activations [M, K], float32 weights
    [N, K] at lecun scale, a float32 bias."""
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
    return x, w, torch.randn(n, device="cuda", generator=gen) * 0.1


def check_int8(label: str, m: int, n: int, k: int, gen) -> dict:
    """Both quantizes and the GEMM (bias, bf16 output) of one site against
    their plain versions, bit for bit; each kernel's, plain version's,
    bound's and library call's ms (the GEMM's: ``torch._int_mm`` and the
    same rescale in PyTorch ops; the quantize has none)."""
    x, w, bias = int8_inputs(m, n, k, gen)
    xq, xs = quant.quantize_rows(x)
    wq, ks = quant.quantize_rows(w)
    qerr = 0.0
    for (q, sc), t, what in (((xq, xs), x, "x"), ((wq, ks), w, "w")):
        pq, ps = quant.quantize_rows_reference(t)
        qerr = max(qerr, (q.int() - pq.int()).abs().max().item(), (sc - ps).abs().max().item())
        assert torch.equal(q, pq) and torch.equal(sc, ps), f"int8 {label} quantize {what}: differs from plain"
    out = quant.int8_gemm(xq, wq, xs, ks, bias, torch.bfloat16)
    want = quant.int8_gemm_reference(xq, wq, xs, ks, bias, torch.bfloat16)
    torch.cuda.synchronize()
    gerr = (out.float() - want.float()).abs().max().item()
    assert torch.equal(out, want), f"int8 {label} gemm: max abs err {gerr}"
    gemm = {"ms": cuda_ms(lambda: quant.int8_gemm(xq, wq, xs, ks, bias, torch.bfloat16), 20),
            "plain_ms": cuda_ms(lambda: quant.int8_gemm_reference(xq, wq, xs, ks, bias, torch.bfloat16), 3),
            "max_abs_err": gerr, "ops_ms": 2e3 * m * n * k / PEAK_INT8,
            "bytes_ms": 1e3 * (m * k + n * k + 4 * (m + 2 * n) + 2 * m * n) / PEAK_BYTES, "library_ms": None}
    if m > 16 and k % 8 == 0 and n % 8 == 0:  # torch._int_mm's shapes
        def library():
            return ((torch._int_mm(xq, wq.t()).float() * xs[:, None]) * ks[None, :] + bias).to(torch.bfloat16)
        assert torch.equal(library(), want), f"int8 {label}: the library yardstick differs"
        gemm["library_ms"] = cuda_ms(library, 20)
    quantize = {"ms": cuda_ms(lambda: (quant.quantize_rows(x), quant.quantize_rows(w)), 20),
                "plain_ms": cuda_ms(lambda: (quant.quantize_rows_reference(x), quant.quantize_rows_reference(w)), 5),
                "max_abs_err": qerr, "ops_ms": 0.0, "bytes_ms": 1e3 * (3 * m * k + 5 * n * k + 4 * (m + n)) / PEAK_BYTES,
                "library_ms": None}
    lib = "n/a" if gemm["library_ms"] is None else f"{gemm['library_ms']:.4f}"
    tile = "x".join(map(str, quant.gemm_tile(m, n)))
    print(f"int8 {label} M={m} N={n} K={k}: quantize x + w {quantize['ms']:.4f} ms (plain "
          f"{quantize['plain_ms']:.4f}, bound {quantize['bytes_ms']:.4f} bytes, "
          f"{100 * quantize['bytes_ms'] / quantize['ms']:.1f} % of it); gemm {gemm['ms']:.4f} ms (plain "
          f"{gemm['plain_ms']:.4f}, _int_mm + rescale {lib}, bound max({gemm['ops_ms']:.4f} ops, "
          f"{gemm['bytes_ms']:.4f} bytes), {100 * max(gemm['ops_ms'], gemm['bytes_ms']) / gemm['ms']:.1f} % of "
          f"the bound, {2 * m * n * k / gemm['ms'] / 1e9:.1f} TOP/s, tile {tile}); bit-equal", flush=True)
    return {"int8_quantize": quantize, "int8_gemm": gemm}


def bf16_linear_ms(m: int, n: int, k: int, gen) -> float:
    """The bf16 ``F.linear`` (bf16 x, w and bias) of a site: what int8
    serving competes with, timed only."""
    x, w, bias = (t.to(torch.bfloat16) for t in int8_inputs(m, n, k, gen))
    return cuda_ms(lambda: F.linear(x, w, bias), 20)


def int8_row(sites: list, name: str) -> dict:
    """The kernels line's row of ``name`` summed over ``sites``."""
    rows = [s[name] for s in sites]
    ops, nbytes = sum(r["ops_ms"] for r in rows), sum(r["bytes_ms"] for r in rows)
    lib = [r["library_ms"] for r in rows]
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": max(ops, nbytes), "bound_by": "operations" if ops > nbytes else "bytes",
            "library_ms": None if None in lib else sum(lib)}


def int8_kernel_phase(card: str, predicted: dict) -> dict:
    """Phase 33: the int8 kernels against their plain versions at LARGE's
    five sites (M of phase 12's longest bucket batch), BASE's at B=48 x 3 s
    and a ragged shape; returns the kernels line's rows (LARGE's sites
    summed, as the LARGE predict path runs them per layer)."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    longest = max(int(sec * 16000) for sec in predicted["files"].values())
    m_large = PREDICT_BATCH * int(feat_extract_output_lengths(-(-longest // PREDICT_PAD) * PREDICT_PAD, LARGE_CONFIG))
    lin_gen = torch.Generator(device="cuda").manual_seed(34)  # the checks' inputs stay those of seed 33
    linear = [bf16_linear_ms(m_large, n, k, lin_gen) for n, k in INT8_LARGE_SITES]
    print(f"bf16 F.linear (bf16 x, w, bias) at LARGE's five sites, M={m_large}: "
          + ", ".join(f"site {i} {ms:.4f} ms" for i, ms in enumerate(linear))
          + f"; summed {sum(linear):.4f} ms [{card}]", flush=True)
    large = [check_int8(f"LARGE site {i}", m_large, n, k, gen) for i, (n, k) in enumerate(INT8_LARGE_SITES)]
    m_base = INT8_BASE_BATCH * int(feat_extract_output_lengths(SAMPLES))
    for i, (n, k) in enumerate(INT8_BASE_SITES):
        check_int8(f"BASE site {i}", m_base, n, k, gen)
    check_int8("ragged", *INT8_RAGGED, gen)
    rows = {name: int8_row(large, name) for name in ("int8_quantize", "int8_gemm")}
    print(f"int8 LARGE five sites summed at M={m_large}: {rows} [{card}]", flush=True)
    return rows


def write_pair_folder(folder: pathlib.Path, seconds, speakers: int, seed: int) -> pathlib.Path:
    """``write_predict_folder``'s files and a pair file of every pair."""
    ids = list(write_predict_folder(folder, seconds, speakers, np.random.default_rng(seed)))
    pairs = folder / "pairs.txt"
    pairs.write_text("".join(f"{a} {b}\n" for i, a in enumerate(ids) for b in ids[i + 1:]))
    return pairs


def int8_serving_phase(card: str, tmp: pathlib.Path, predicted: dict, run_args: list) -> dict:
    """Phase 34: int8 serving end to end. (a) ``predict.main`` with
    ``network.int8_matmuls=true`` at full LARGE width on the fused conv on
    phase 12's files and trials: the scores within ``INT8_SCORE_ATOL`` of
    phase 12's bf16 ones, per bucket batch 97 GEMMs, 194 quantizes, 24
    attention forwards and 6 convs, warm utt/s beside phase 12's; (b) BASE
    ``auto`` over buckets on both sides of the threshold, its routing line
    against ``int8_auto_policy``; (c) BASE full precision against int8
    extraction at 3, 6 and 12 s (the card's crossover; recorded, not
    applied); (d) ``run.main`` eval-only with int8 from phase 13's best
    checkpoint. Returns phase (a)'s launches of the int8 kernels."""
    import shutil

    from w2v2_speaker_tpu_torch.runtime.predict import build_predict_model as build

    # (a) LARGE, int8 everywhere
    folder, batches = predicted["folder"], predicted["batches"]
    shutil.rmtree(folder / "embeddings")
    overrides = [*predicted["overrides"], "network.int8_matmuls=true"]
    reset_launches()
    reset_int8_launches()
    score_file = predict.main(overrides)
    torch.cuda.synchronize()
    got, got8 = launches(), int8_launches()
    assert got == {"flash_attention_fwd": 24 * batches, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                   "conv_encoder": 6 * batches}, f"int8 predict launched {got}"
    assert got8 == {"int8_quantize": 2 * INT8_GEMMS * batches, "int8_gemm": INT8_GEMMS * batches}, \
        f"int8 predict launched {got8} over {batches} bucket batches"
    scores, pairs = read_scores(score_file)
    assert pairs == predicted["pairs"] and np.all(np.isfinite(scores)), "int8 predict: score lines"
    drift = float(np.abs(scores - predicted["scores"]).max())
    assert drift <= INT8_SCORE_ATOL, f"int8 predict scores {drift} from bf16's"
    model = build(load_config(predict.CONFIG_DIR, "predict", overrides))
    samples = [SpeakerSample(rel, normalize_waveform(load_raw_audio(folder / rel))) for rel in predicted["files"]]
    extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH)  # warm-up
    warm = []
    for _ in range(PREDICT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH)
        warm.append(time.perf_counter() - t0)
    del model
    utt_s = len(samples) / float(np.median(warm))
    print(f"int8 predict LARGE fused conv (network.int8_matmuls=true): {len(samples)} files, {batches} bucket batches, "
          f"launches {got} {got8}; scores vs phase 12's bf16: max diff {drift:.3e} (limit {INT8_SCORE_ATOL}); warm "
          f"extraction median over {len(warm)}: {utt_s:.2f} utt/s ({len(samples) / max(warm):.2f}-"
          f"{len(samples) / min(warm):.2f}) against bf16's {predicted['utt_s']:.2f} (phase 12) [{card}]", flush=True)

    # (b) BASE auto on buckets of 48 000 and 144 000 samples
    auto = tmp / "int8_auto"
    pairs_file = write_pair_folder(auto, INT8_AUTO_S, 2, 34)
    weights = tmp / "base_34.pt"
    torch.save(build_model(torch.device("cuda"), torch.float32, seed=34).state_dict(), weights)
    base = ["network=wav2vec2_fc", "trainer.precision=bf16", f"load_network_from_checkpoint={weights}",
            f"data.dataloader.test_pad_to_multiple={PREDICT_PAD}", f"data.dataloader.test_batch_size={PREDICT_BATCH}",
            f"predict_folder_path={auto}", f"pair_prediction_path={pairs_file}"]
    padded = [-(-int(max(INT8_AUTO_S[i:i + PREDICT_BATCH]) * 16000) // PREDICT_PAD) * PREDICT_PAD
              for i in range(0, len(INT8_AUTO_S), PREDICT_BATCH)]
    threshold = quant.INT8_AUTO_MIN_SAMPLES
    n8 = sum(quant.int8_auto_policy(p, BASE_CONFIG.hidden_size, threshold) for p in padded)
    assert 0 < n8 < len(padded), f"auto: buckets {padded} do not straddle {threshold}"
    reset_launches()
    reset_int8_launches()
    _, out = captured(predict.main, [*base, "network.int8_matmuls=auto"])
    routing = [line for line in out.splitlines() if line.startswith("int8 auto dispatch")]
    want = f"int8 auto dispatch: {n8}/{len(padded)} bucket batches on int8 (threshold {threshold} samples)"
    assert routing == [want], f"auto routing {routing}, the policy says {want!r}"
    assert int8_launches()["int8_gemm"] == 49 * n8 and launches()["flash_attention_fwd"] == 12 * len(padded), \
        f"auto launched {launches()} {int8_launches()}"
    print(f"int8 auto BASE bf16: padded bucket batches {padded}: {want!r}, int8 GEMMs {int8_launches()['int8_gemm']}",
          flush=True)

    # (c) the crossover: full precision against int8, the same weights, in turns
    model = build(load_config(predict.CONFIG_DIR, "predict", [*base, "network.int8_matmuls=true"]))
    report = []
    with torch.inference_mode():
        for sec in INT8_CROSSOVER_S:
            wav = torch.randn(INT8_CROSSOVER_BATCH, sec * 16000, device="cuda") * 0.1
            times = {False: [], True: []}
            for int8 in (False, True, True, False):
                quant.int8_enabled(model, int8)
                times[int8].append(cuda_ms(lambda: model.compute_embedding(wav), 10))
            full, int8 = np.mean(times[False]), np.mean(times[True])
            report.append(f"{sec} s: full {full:.3f} ms, int8 {int8:.3f} ms ({100 * (full / int8 - 1):+.1f} %)")
    del model
    print(f"int8 crossover BASE bf16 B={INT8_CROSSOVER_BATCH} (CUDA events, 10 forwards, full/int8/int8/full): "
          f"{'; '.join(report)} [{card}]", flush=True)

    # (d) the run twin, eval-only from phase 13's best checkpoint
    from w2v2_speaker_tpu_torch import run

    reset_launches()
    reset_int8_launches()
    objective = run.main([*run_args, "fit_model=false", "network.int8_matmuls=true",
                          f"load_network_from_checkpoint={tmp / 'ckpt' / 'best'}",
                          f"trainer.checkpoint_dir={tmp / 'int8_eval_ckpt'}"])
    fwd, gemms = launches()["flash_attention_fwd"], int8_launches()["int8_gemm"]
    assert objective is not None and 0 <= objective <= 1, f"int8 eval-only: objective {objective}"
    assert fwd > 0 and fwd % 12 == 0 and gemms == 49 * fwd // 12, f"int8 eval-only launched {fwd}, {gemms}"
    assert not (tmp / "int8_eval_ckpt" / "last").exists(), "int8 eval-only saved a checkpoint"
    print(f"int8 eval-only run (fit_model=false, phase 13's best): test EER {objective:.4f}, {fwd // 12} forwards of "
          f"12 attention launches and 49 int8 GEMMs each [{card}]", flush=True)
    return got8


def run_child(tmp: pathlib.Path, name: str, runs: list, env: dict) -> dict:
    """``RUN_CHILD`` in a fresh process on ``runs`` ([(label, argv)]); its
    JSON record."""
    out, spec = tmp / f"{name}.json", tmp / f"{name}_runs.json"
    spec.write_text(json.dumps(runs))
    proc = subprocess.run([sys.executable, "-c", RUN_CHILD, str(out), str(spec)], cwd=ROOT, env=env,
                          capture_output=True, text=True)
    sys.stdout.write(proc.stdout[-1500:])
    assert proc.returncode == 0, f"{name}: exit {proc.returncode}\n{proc.stderr[-4000:]}"
    return json.loads(out.read_text())


def deterministic_pair(tmp: pathlib.Path, name: str, runs: list, env: dict) -> tuple:
    """``runs`` under ``trainer.deterministic=true`` in two fresh processes
    (``RUN_CHILD``): each run's losses and final parameters bit-equal
    between the two, ``CUBLAS_WORKSPACE_CONFIG`` set in both. Returns the
    two records."""
    a, b = (run_child(tmp, f"{name}_{i}", runs, env) for i in "ab")
    assert a["cublas"] == b["cublas"] == ":4096:8", (a["cublas"], b["cublas"])
    for label, _ in runs:
        ra, rb = a["runs"][label], b["runs"][label]
        assert ra["losses"] and ra["losses"] == rb["losses"], f"deterministic {label}: losses {ra} {rb}"
        differ = [k for k, v in ra["params"].items() if rb["params"][k] != v]
        assert ra["params"].keys() == rb["params"].keys() and not differ, \
            f"deterministic {label}: {len(differ)} parameters differ, {differ[:4]}"
    return a, b


def step_ms(rec: dict) -> float:
    """Mean device ms between consecutive steps' ends of a ``RUN_CHILD``
    record."""
    return float(np.mean(rec["step_ms"]))


def knobs_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 35: (a) ``trainer.deterministic=true`` on the BASE CE recipe at
    full width, 4 steps, twice, each in a fresh process (so that
    ``CUBLAS_WORKSPACE_CONFIG`` holds from its start): the losses and final
    parameters bit-equal, ms/step against the same run without the flag and
    phase 13's; every other recipe one step under the flag, the CTC ones
    included; (b) ``profiler=simple`` over 12 steps: the trace
    of its window, no sanity validation; (c) ``trainer.remat`` on the LARGE
    AAM step (B=48, fused conv) under each policy against no remat, from the
    same weights and generator seed: loss, gradients and the generator bit
    for bit, peak memory and ms/step."""
    import os

    from w2v2_speaker_tpu_torch import run

    # trainer.fast_dev_run=N: N steps, no checkpoint written (each would
    # write a GiB or more to the machine's disk, whose writes are capped)
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    base = ["+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}", "seed=13",
            f"trainer.fast_dev_run={DET_STEPS}", "eval_model=false"]
    a, b = (r["runs"]["ce"] for r in deterministic_pair(
        tmp, "det", [("ce", [*base, "trainer.deterministic=true",
                             *corpus_args(wav_dir, trials, shards, tmp / "det_ckpt")])], env))
    nondet = run_child(tmp, "nondet", [("ce", [*base, "trainer.deterministic=false",
                                               *corpus_args(wav_dir, trials, shards, tmp / "nondet_ckpt")])], env)
    assert len(a["losses"]) == DET_STEPS and nondet["cublas"] is None, (a, nondet["cublas"])
    # ms/step: the end of step 1 to the end of step 4 (one dispatch of 4), per step
    print(f"deterministic BASE CE bf16 B=66, {DET_STEPS} steps in two fresh processes: losses bit-equal "
          f"{[float.fromhex(x) for x in a['losses']]}, {len(a['params'])} parameters bit-equal; ms/step (CUDA events, "
          f"steps 2-{DET_STEPS}) {step_ms(a):.2f} and {step_ms(b):.2f} against {step_ms(nondet['runs']['ce']):.2f} "
          f"without the flag (a third process) and phase 13's {MEASURED['run_ms']:.2f} (CUDA events) [{card}]",
          flush=True)

    one = ["trainer.fast_dev_run=1", "eval_model=false", "trainer.deterministic=true", "trainer.log_dir=null", ONE_RANK]
    triplet = tmp / "triplet"
    runs = [(r, [f"+experiment={r}", f"data.shards.samples_per_shard={RUN_SHARD}", *extra,
                 *corpus_args(wav_dir, trials, shards, tmp / "det" / "_".join([r, *extra])), *one])
            for r, extra in (("speaker_wav2vec2_aam", []), ("speaker_wav2vec2_short_seq", []),
                             ("speaker_wav2vec2_large_aam", ["network.conv_impl=fused_pallas"]),
                             ("speaker_xvector", []), ("speaker_ecapa_tdnn", []), ("speaker_wav2spk", []),
                             ("speaker_dummy", []), ("speaker_wav2vec2_ce", ["network=wav2vec_fc"]),
                             ("speaker_wav2vec2_ce", ["network=wav2vec_xvector"]),
                             ("speaker_wav2vec2_ctc", []))]
    runs += [("speaker_wav2vec2_pairs", ["+experiment=speaker_wav2vec2_pairs",
                                         f"data.shards.samples_per_shard={PAIRS_SHARD}", *one,
                                         *corpus_args(wav_dir, trials, tmp / "pair_shards", tmp / "det" / "pairs")])]
    runs += [(r, [f"+experiment={r}", f"data.shards.samples_per_shard={RUN_SHARD + 2}", *one,
                  *corpus_args(triplet / "wav", triplet / "trials.txt", tmp / "triplet_shards", tmp / "det" / r)])
             for r in ("speaker_wav2vec2_triplet", "speaker_wav2vec2_triplet_ce")]
    runs += [("speech_wav2vec2_ctc", ["+experiment=speech_wav2vec2_ctc", *speech_args(tmp), "seed=16", *one,
                                      f"trainer.checkpoint_dir={tmp / 'det' / 'speech'}"]),
             ("multitask_wav2vec2", ["+experiment=multitask_wav2vec2", *mt_args(tmp), "seed=16", *one,
                                     f"trainer.checkpoint_dir={tmp / 'det' / 'multitask'}"])]
    runs = [(f"{label} {' '.join(a for a in argv if a.startswith('network='))}".strip(), argv)
            for label, argv in runs]
    (tmp / "det_runs.json").write_text(json.dumps(runs))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RECIPES_CHILD, str(tmp / "det_done.json"), str(tmp / "det_runs.json")],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, (f"deterministic recipes: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                                  f"{proc.stderr[-4000:]}")
    done = dict(json.loads((tmp / "det_done.json").read_text()))
    assert list(done) == [label for label, _ in runs] and set(done.values()) == {"trained"}, \
        f"deterministic recipes: {done}"
    print(f"deterministic recipes, one step each in one fresh process ({time.perf_counter() - t0:.1f} s): every "
          f"recipe trained, the CTC ones included: {list(done)}", flush=True)

    # (b) profiler=simple, 12 steps: its window is steps 11-15, cut by the run's end at 12
    trace_dir = tmp / "profile"
    argv = ["+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}", "seed=13",
            f"trainer.max_steps={PROFILE_STEPS}", f"trainer.val_check_interval={PROFILE_STEPS}",
            "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=2", "eval_model=false", "profiler=simple",
            f"profiler.trace_dir={trace_dir}", *corpus_args(wav_dir, trials, shards, tmp / "profile_ckpt")]
    with RunProbe() as probe:
        _, out = captured(run.main, argv)
    first = PROFILE_WINDOW[0] + 1
    trace = (trace_dir / "trace.json").read_text()
    import re

    steps_in = set()  # the steps of the dispatches the trace names: train_step_<n> or train_steps_<a>-<b>
    for a, b in re.findall(r'"train_steps?_(\d+)(?:-(\d+))?"', trace):
        steps_in.update(range(int(a), int(b or a) + 1))
    assert steps_in == set(range(first, PROFILE_STEPS + 1)), f"profiler: steps in the trace {sorted(steps_in)}"
    names = ("fwd_bf16_kernel", "dq_bf16_kernel", "dkv_bf16_kernel")
    assert all(n in trace for n in names), f"profiler: the trace names no attention kernel of {names}"
    assert "sanity validation" not in out, "profiler: a sanity validation ran in a profiled run"
    assert f"profiler: steps {first}-{PROFILE_STEPS} traced to {trace_dir / 'trace.json'}" in out
    spans = probe.spans_ms(0, PROFILE_STEPS - 1)
    print(f"profiler=simple on BASE CE bf16 B=66, {PROFILE_STEPS} steps: trace of steps {first}-{PROFILE_STEPS} "
          f"({len(trace) / 2**20:.1f} MiB, the three attention kernels named), no sanity validation; step spans "
          f"(CUDA events) outside the window {np.mean(spans[4:first - 1]):.2f} ms, inside "
          f"{np.mean(spans[first - 1:]):.2f} ms [{card}]", flush=True)

    # (c) remat on the LARGE AAM step
    # cuDNN's deterministic algorithms for the convolutions outside the layers
    # (conv 0, the pos conv), whose weight gradients some algorithms sum with
    # atomics; what remat changes runs on the kernels and cuBLAS
    dev = torch.device("cuda")
    batch = {k: v[0] for k, v in synthetic_batch(LARGE_BATCH, SAMPLES, dev, seed=35).items()}
    want, report = None, []
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "dots"), (True, "dots_no_batch")):
            cfg = load_recipe("speaker_wav2vec2_large_aam", ["network.conv_impl=fused_pallas", f"trainer.remat={remat}",
                                                             f"network.remat_policy={policy}"])
            held = fresh_phase()
            state, task = build_train_state(dev, "bf16", cfg, seed=0)
            step = make_train_step(task)
            state, metrics = step(state, batch)
            got = (metrics["loss"].float(), {n: p.grad.clone() for n, p in state.named_params() if p.grad is not None},
                   state.generator.get_state())
            if want is None:
                want = got
            else:
                differ = [n for n, g in want[1].items() if not torch.equal(got[1][n], g)]
                assert torch.equal(got[0], want[0]) and not differ and torch.equal(got[2], want[2]), \
                    f"remat {policy}: loss {got[0].item()} vs {want[0].item()}, {len(differ)} gradients differ " \
                    f"{differ[:3]}"
            del got
            torch.cuda.reset_peak_memory_stats()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(2):
                state, metrics = step(state, batch)
            stop.record()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            report.append(f"{'remat ' + policy if remat else 'no remat'}: {start.elapsed_time(stop) / 2:.1f} ms/step, "
                          f"peak {peak:.2f} GiB")
            del state, task, step, metrics
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    print(f"remat LARGE AAM fused conv bf16 B={LARGE_BATCH} x {SAMPLES}: loss, gradients and generator bit-equal "
          f"to no remat under each policy; {'; '.join(report)} (CUDA events, steps 2-3; peak above the memory "
          f"held) [{card}]", flush=True)


# ------------------------------------------------ 36-37: data and tensor parallelism

DP_ATTN_SHAPES = [  # (name, B, T, lengths, heads): LARGE training and a ragged speech training batch
    ("large_train_3s", LARGE_BATCH, 149, [149] * LARGE_BATCH, H_LARGE),
    ("speech_train", 8, 1199, [1199, 1100, 937, 720, 512, 349, 201, 64], H),
]
DP_STEPS, DP_WORLD = 4, 2
DP_LOSS_RTOL = 1.5e-3  # the bf16 loss limit of the card-vs-card runs
# steps 2-4 of the bf16 runs: four runs on an H100 read at most 1.12e-4
# relative (the 1-rank run alone moves 9e-5 from run to run)
DP_LATER_LOSS_RTOL = 1e-3
DP_F32_LOSS_RTOL = 1e-5
# float32 gradients against 1 rank: the largest over parameters of
# |g - g1| / |g1| (L2 norms; a wrong reduce scale reads >= 0.5). On an H100
# 2 ranks in full float32 read 1.90e-6 (10x that is the limit) and dp=2 x
# tp=2 1.70e-6 (60x); with cuDNN's TF32 on in the ranks, as they once ran,
# 2 ranks read 9.54e-4 and 1 rank against itself in full float32 9.60e-4,
# at the first conv's weight both
DP_F32_GRAD_REL, TP_GRAD_REL = 2e-5, 1e-4
DP_DEADLINE = 900.0


def grad_rel_err(got: dict, want: dict) -> tuple:
    """(the largest over parameters of |got - want| / |want| in L2 norm,
    its parameter, the largest |want| entry); a parameter whose gradient is
    zero in ``want`` counts its absolute difference."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    worst, at = 0.0, None
    for name, g in want.items():
        norm = float(g.double().norm())
        err = float((got[name].double() - g.double()).norm()) / (norm if norm > 0 else 1.0)
        if err >= worst:
            worst, at = err, name
    return worst, at, max(float(g.abs().max()) for g in want.values())


def offset_kernel_phase(card: str) -> dict:
    """Phase 36 (a) i: the three attention kernels at rate 0.1 on a block of
    rows (coords (b0, 0, 0)) and on a block of heads (coords (0, h0, H)) of
    a global input, each output bit-equal to the same rows (heads) of the
    global launch's; bf16 and f32, the LARGE and a speech shape. Returns
    the launches it made."""
    gen = torch.Generator(device="cuda").manual_seed(36)
    seed, rate, made = DROPOUT_SEED, 0.1, 0
    for name, b, t, lengths, h in DP_ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, lens = attention_inputs(b, t, lengths, dtype, gen, h)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=True)
            args = (q, k, v, do, lse, fa.attention_delta(o, do), lens, rate, seed)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            made += 3
            b0, nb, h0, nh = b // 2, b - b // 2, h // 2, h - h // 2
            for label, rows, heads, coords in (("rows", slice(b0, b0 + nb), slice(None), (b0, 0, 0)),
                                               ("heads", slice(None), slice(h0, h0 + nh), (0, h0, h))):
                qb, kb, vb, dob = (x[rows, :, heads] for x in (q, k, v, do))
                lb = lens[rows]
                ob, lseb = fa.flash_attention_fwd(qb, kb, vb, lb, rate, seed, return_lse=True, coords=coords)
                bargs = (qb, kb, vb, dob, lseb, fa.attention_delta(ob, dob), lb, rate, seed)
                dqb = fa.flash_attention_bwd_dq(*bargs, coords=coords)
                dkb, dvb = fa.flash_attention_bwd_dkv(*bargs, coords=coords)
                made += 3
                for out, got, want in (("o", ob, o[rows, :, heads]), ("lse", lseb, lse[rows, heads]),
                                       ("dq", dqb, dq[rows, :, heads]), ("dk", dkb, dk[rows, :, heads]),
                                       ("dv", dvb, dv[rows, :, heads])):
                    assert torch.equal(got, want), (
                        f"offset kernels {name} {dtype} {label} {out}: max diff {(got.float() - want.float()).abs().max()}")
            print(f"offset kernels {name} {str(dtype).removeprefix('torch.')} B={b} T={t} H={h} rate {rate}: "
                  f"rows [{b0}, {b}) and heads [{h0}, {h}) bit-equal to the global launch (o, lse, dq, dk, dv) "
                  f"[{card}]", flush=True)
    return made


def dp_rank_run(argv: list) -> dict:
    """One rank of phase 36 (a) ii (also the 1-rank run): ``run.main(argv)``
    with every train step recorded (the loss, its attention launches and
    kept layers, its CUDA-synchronised ms, the gradient all-reduce's ms)
    and, with more than one rank, every rank's parameters and buffers
    hashed after each step and compared."""
    import hashlib

    import torch.distributed as dist
    from w2v2_speaker_tpu_torch import run
    from w2v2_speaker_tpu_torch.parallel import mesh as pmesh
    from w2v2_speaker_tpu_torch.runtime import experiment
    from w2v2_speaker_tpu_torch.train import steps as steps_mod

    rec = {"steps": [], "allreduce_ms": []}
    make, reduce = experiment.make_train_step, steps_mod.all_reduce_grads

    def timed_reduce(params, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(params, mesh)
        torch.cuda.synchronize()
        rec["allreduce_ms"].append(1e3 * (time.perf_counter() - t0))

    def recorded(task, *a, **kw):
        step = make(task, *a, **kw)

        def run_step(state, batch):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            equal = True
            if dist.is_initialized() and dist.get_world_size() > 1:
                h = hashlib.sha256()
                for name, x in sorted(state.model.state_dict().items()):
                    h.update(name.encode())
                    h.update(x.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
                digests = [None] * dist.get_world_size()
                dist.all_gather_object(digests, h.hexdigest(), group=pmesh.current_mesh().host_group)
                equal = len(set(digests)) == 1
            rec["steps"].append({"loss": float(metrics["loss"]), "layers": round(float(metrics["layers_run"])),
                                 "launches": [launches()[k] for k in ATTENTION], "ms": ms, "replicas_equal": equal})
            return state, metrics

        return run_step

    experiment.make_train_step, steps_mod.all_reduce_grads = recorded, timed_reduce
    try:
        rec["objective"] = run.main(argv)
    finally:
        experiment.make_train_step, steps_mod.all_reduce_grads = make, reduce
    return rec


def dp_run_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 36 (a) ii: the BASE CE recipe at full width (bf16, B=66 global)
    through ``run.main`` for 4 steps on 2 ranks sharing this one card over
    a gloo group that the caller makes (``spawn(..., backend="gloo")``),
    against a 1-rank run from the same state in this process: the step-1
    loss within 1.5e-3 relative, steps 2-4 within 1e-3, the replicas
    bit-identical after every step, each rank's attention launches per
    step equal to its kept layers. Under Adam a uniform scale of the
    gradient barely moves the losses: phase 36 (a) iii holds the gradients
    themselves. Two ranks on one card are not a scaling measurement, and
    gloo stages BASE's ~378 MB of float32 gradients through the host."""
    from w2v2_speaker_tpu_torch.parallel.mesh import spawn

    argv = ["+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}", "seed=13",
            *corpus_args(wav_dir, trials, shards, tmp / "dp_ckpt"), f"trainer.max_steps={DP_STEPS}",
            f"trainer.val_check_interval={DP_STEPS}", "trainer.steps_per_dispatch=1", "trainer.limit_val_batches=1",
            "trainer.limit_test_batches=0", "trainer.num_sanity_val_steps=0", "trainer.log_every=1"]
    t0 = time.perf_counter()
    two = spawn(dp_rank_run, ([*argv, f"trainer.num_devices={DP_WORLD}"],), nprocs=DP_WORLD, device="cuda",
                backend="gloo", deadline=DP_DEADLINE)
    two_s = time.perf_counter() - t0
    one = dp_rank_run([*argv, "trainer.num_devices=1", f"trainer.checkpoint_dir={tmp / 'dp1_ckpt'}"])
    for label, rec in (("2 ranks", two), ("1 rank", one)):
        assert len(rec["steps"]) == DP_STEPS, f"data parallel {label}: {len(rec['steps'])} steps"
        for i, s in enumerate(rec["steps"]):
            assert s["replicas_equal"], f"data parallel {label} step {i + 1}: replicas differ"
            assert s["launches"] == [s["layers"]] * 3, f"data parallel {label} step {i + 1}: {s}"
            assert np.isfinite(s["loss"]), f"data parallel {label} step {i + 1}: loss {s['loss']}"
    l2, l1 = two["steps"][0]["loss"], one["steps"][0]["loss"]
    assert abs(l2 - l1) <= DP_LOSS_RTOL * abs(l1), f"data parallel step-1 loss {l2} vs 1 rank {l1}"
    rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(two["steps"], one["steps"])]
    assert max(rels[1:]) <= DP_LATER_LOSS_RTOL, f"data parallel losses 2-{DP_STEPS}: rel {rels}"
    ms2 = [round(s["ms"], 1) for s in two["steps"]]
    ms1 = [round(s["ms"], 1) for s in one["steps"]]
    MEASURED["dp_ms"] = (float(np.mean(ms2[1:])), float(np.mean(ms1[1:])),
                         float(np.mean(two["allreduce_ms"][1:])))
    print(f"data parallel BASE bf16 B=66 global: 2 ranks on one card over gloo, step-1 loss {l2:.6f} vs 1 rank "
          f"{l1:.6f} (rel {abs(l2 - l1) / abs(l1):.2e}, limit {DP_LOSS_RTOL}); losses 2 ranks "
          f"{[round(s['loss'], 6) for s in two['steps']]}, 1 rank {[round(s['loss'], 6) for s in one['steps']]}, "
          f"rel {[f'{r:.2e}' for r in rels]} (steps 2-{DP_STEPS} limit {DP_LATER_LOSS_RTOL}); "
          f"replicas bit-identical after each of {DP_STEPS} steps; launches per rank per step = kept layers "
          f"{[s['layers'] for s in two['steps']]}; ms/step (host clock, synchronised; two ranks sharing one card, "
          f"not a scaling number) 2 ranks {ms2}, 1 rank {ms1}; gradient all-reduce (gloo, through the host) ms per "
          f"step {[round(x, 1) for x in two['allreduce_ms']]}; the 2-rank run {two_s:.1f} s with its spawn "
          f"[{card}]", flush=True)


def dp_f32_phase(card: str) -> None:
    """Phase 36 (a) iii: a 2-layer full-width (BASE) float32 speaker CE step
    on 2 gloo ranks on the card against 1 rank (loss within 1e-5 relative,
    each parameter's gradient within ``DP_F32_GRAD_REL`` of the 1-rank
    gradient's norm, the replicas bit-identical); each rank's share of it
    run in this process in turn (``split_step_case``, which sums what the
    ranks all-reduce); the same 2-rank and 1-rank steps with cuDNN's TF32
    on (PyTorch's default, under which a spawned rank once ran while this
    process ran full float32); then one step in a world of 1 over NCCL
    (its all-reduce probe included)."""
    from tools.torch_parallel_cases import rank_cases, split_step_case, step_case
    from w2v2_speaker_tpu_torch.parallel.mesh import spawn

    cfg = {**BASE_CONFIG.__dict__, "num_layers": 2, "dtype": "float32"}
    with torch.device("meta"):
        model = Wav2Vec2SpeakerModel(Wav2Vec2SpeakerConfig(w2v2=Wav2Vec2Config(**cfg), stat_pooling_type="mean"),
                                     num_speakers=64)
    model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(36))
    rng = np.random.default_rng(36)
    lengths = rng.integers(24000, 48001, 8)
    mask = np.arange(48000)[None, :] < lengths[:, None]
    case = {"kind": "speaker", "w2v2": cfg, "config": {"stat_pooling_type": "mean"}, "speakers": 64, "acc": 2,
            "seed": 5, "state_dict": model.state_dict(),
            "batch": {"features": (rng.normal(0, 0.1, (8, 48000)) * mask).astype(np.float32), "mask": mask,
                      "labels": rng.integers(0, 64, 8).astype(np.int32)}}
    tf32 = {**case, "tf32": True}
    two, two_tf32 = spawn(rank_cases, ([case, tf32], "cuda"), nprocs=DP_WORLD, device="cuda", backend="gloo",
                          deadline=DP_DEADLINE)
    one = step_case({**case, "device": "cuda"})
    one_tf32 = step_case({**tf32, "device": "cuda"})
    split = split_step_case({**case, "device": "cuda"})
    set_float32_precision()  # this process's own setting again
    nccl = spawn(rank_cases, ([case], "cuda"), nprocs=1, device="cuda", deadline=DP_DEADLINE)[0]
    assert two["tf32"] == one["tf32"] == (False, False) and two_tf32["tf32"] == one_tf32["tf32"] == (False, True)
    rel = abs(two["loss"] - one["loss"]) / abs(one["loss"])
    grad, at, top = grad_rel_err(two["grads"], one["grads"])
    absdiff = max(float((two["grads"][n] - g).abs().max()) for n, g in one["grads"].items())
    assert two["replicas_equal"] and rel <= DP_F32_LOSS_RTOL and grad <= DP_F32_GRAD_REL, (
        f"data parallel f32: replicas equal {two['replicas_equal']}, loss rel {rel}, grad rel {grad} at {at}")
    assert abs(nccl["loss"] - one["loss"]) <= DP_F32_LOSS_RTOL * abs(one["loss"]), f"NCCL world of 1 {nccl['loss']}"
    split_two = grad_rel_err(split["grads"], two["grads"])
    split_one = grad_rel_err(split["grads"], one["grads"])
    tf32_one = grad_rel_err(one_tf32["grads"], one["grads"])
    tf32_two = grad_rel_err(two_tf32["grads"], one["grads"])
    tf32_both = grad_rel_err(two_tf32["grads"], one_tf32["grads"])
    bit_equal = all(torch.equal(split["grads"][n], g) for n, g in two["grads"].items())
    print(f"data parallel f32 BASE width 2 layers B=8 x 48000 acc 2, full float32 in every rank: 2 ranks vs 1 loss rel "
          f"{rel:.2e} (limit {DP_F32_LOSS_RTOL}), gradient |g - g1| / |g1| at most {grad:.2e} ({at}; limit "
          f"{DP_F32_GRAD_REL}), largest |diff| {absdiff:.2e} against a largest |g1| of {top:.2e}, replicas "
          f"bit-identical; the ranks' shares summed in this process: {split_two[0]:.2e} from the 2 ranks "
          f"({split_two[1]}; bit-equal {bit_equal}), {split_one[0]:.2e} from 1 rank ({split_one[1]}); with cuDNN's "
          f"TF32 on: 1 rank {tf32_one[0]:.2e} from 1 rank in full float32 ({tf32_one[1]}), 2 ranks {tf32_two[0]:.2e} "
          f"from it ({tf32_two[1]}), 2 ranks vs 1 rank both in TF32 {tf32_both[0]:.2e} ({tf32_both[1]}); NCCL world "
          f"of 1 loss {nccl['loss']:.6f} vs {one['loss']:.6f} [{card}]", flush=True)


def tp_phase(card: str) -> None:
    """Phase 37 (b): ``dryrun_multichip(4)`` at BASE width (768 hidden, 12
    heads, 2 layers; float32, 1 s clips, 8 rows) on 4 ranks sharing the card
    over gloo: dp=2 x tp=2, each rank's attention kernels on its 6 heads,
    the sharded eval and the checkpoint restored onto dp=2, against the
    same dry run in one process: the three losses within 1e-5 relative, the
    released step's gradients, gathered from the shards, within
    ``TP_GRAD_REL`` of the 1-process gradients' norms."""
    cfg = Wav2Vec2Config(**{**BASE_CONFIG.__dict__, "num_layers": 2, "dtype": "float32"})
    t0 = time.perf_counter()
    four = dryrun_multichip(4, "cuda", w2v2=cfg, samples=16000, rows=8, backend="gloo", deadline=DP_DEADLINE)
    four_s = time.perf_counter() - t0
    one = dryrun_multichip(1, "cuda", w2v2=cfg, samples=16000, rows=8)
    assert four["kind"] == "dp=2 x tp=2" and four["local_heads"] == H // 2, f"tp: {four['kind']}, {four['local_heads']}"
    kept = round(2 * four["layers_run"])  # both microbatches' kept layers
    assert four["step_launches"] == [kept] * 3 and kept > 0, f"tp: launches {four['step_launches']}, kept {kept}"
    rels = [abs(four[k] - one[k]) / abs(one[k]) for k in ("loss", "released_loss", "restored_loss")]
    assert max(rels) <= DP_F32_LOSS_RTOL, f"tp: losses {rels}"
    grad, at, top = grad_rel_err(four["grads"], one["grads"])
    assert grad <= TP_GRAD_REL, f"tp: gradient rel {grad} at {at}"
    print(f"tensor parallel dryrun_multichip(4) BASE width 2 layers f32: {four['kind']} on one card over gloo, "
          f"{four['local_heads']} heads a rank, attention launches on rank 0 {four['step_launches']} for {kept} kept "
          f"layer runs; loss {four['loss']:.6f} vs 1 process {one['loss']:.6f} (rel {rels[0]:.2e}); the backbone "
          f"released: loss {four['released_loss']:.6f} vs {one['released_loss']:.6f} (rel {rels[1]:.2e}), gradient "
          f"|g - g1| / |g1| at most {grad:.2e} ({at}; limit {TP_GRAD_REL}; largest |g1| {top:.2e}); embeddings "
          f"{four['embeddings']}, CTC logits {four['logits']}; restored onto dp={four['restored_onto']}, loss "
          f"{four['restored_loss']:.6f} vs {one['restored_loss']:.6f} (rel {rels[2]:.2e}); {four_s:.1f} s with its "
          f"spawn [{card}]",
          flush=True)


# ------------------------------------------------------------ 38: multi-rank predict

# 2 ranks against phase 12's 1 rank, on the (s + 1) / 2 scale: cuBLAS's bf16
# GEMMs at another M (2 rows a rank instead of 4) may round otherwise, while
# the attention and conv kernels compute each row alone
MP_SCORE_ATOL = 2e-3
MP_F32_ATOL = 1e-5  # the float32 sub-case: the same model in full float32, other row counts
MP_TIMED = 5  # warm extractions timed a run


def multi_predict_rank(argv: list, f32_argv: list, files: list, reps: int) -> list:
    """One rank of phase 38, on the world it is spawned in: the predict
    twin on ``argv``, then on ``f32_argv`` (each through
    ``tools/torch_parallel_cases.py::predict_rank``: every rank's score
    file, saved files and launches), then ``reps`` warm extractions of
    ``files`` (under ``argv``'s folder) over the same mesh, synchronised
    across the ranks before and after each. Returns the two runs' records
    and every rank's device and warm seconds."""
    import torch.distributed as dist
    from tools.torch_parallel_cases import predict_rank
    from w2v2_speaker_tpu_torch.parallel.mesh import create_mesh

    runs = [predict_rank(a, None) for a in (argv, f32_argv)]
    cfg = load_config(predict.CONFIG_DIR, "predict", argv)
    mesh = create_mesh(dist.get_world_size(), device="cuda")
    model = build_predict_model(cfg, mesh.device)
    folder = pathlib.Path(cfg["predict_folder_path"])
    samples = [SpeakerSample(rel, normalize_waveform(load_raw_audio(folder / rel))) for rel in files]
    warm = []
    for i in range(reps + 1):  # the first is the warm-up
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract_embeddings(model, samples, PREDICT_PAD, PREDICT_BATCH, device=mesh.device, mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        if i:
            warm.append(time.perf_counter() - t0)
    timing = [None] * mesh.world
    dist.all_gather_object(timing, {"device": str(mesh.device), "warm_s": warm})
    return [runs, timing]


def multi_predict_phase(card: str, tmp: pathlib.Path, predicted: dict) -> None:
    """Phase 38: phase 12's predict (LARGE, fused conv, bf16, its 24 files
    copied to a fresh folder) with ``trainer.num_devices=2`` on 2 gloo
    ranks sharing this card, in a group made here (NCCL refuses one card
    twice), against phase 12's 1-rank scores; the float32 sub-case against
    1 rank in this process; with 2 or more cards the same over NCCL, a
    card a rank, at 2 and at every card."""
    import shutil

    from w2v2_speaker_tpu_torch.parallel.mesh import spawn

    def folders(name: str) -> tuple:
        """A fresh copy of phase 12's files and trials, and a float32 folder
        of 4 files of <= 3 s: (bf16 argv, f32 argv, the two folders)."""
        root = tmp / "multi_predict" / name
        shutil.copytree(predicted["folder"], root / "wav", ignore=shutil.ignore_patterns("embeddings"))
        trials = root / "trials.txt"
        shutil.copy(tmp / "predict" / "trials.txt", trials)
        small = root / "f32"
        ids = list(write_predict_folder(small, PREDICT_F32_S, 2, np.random.default_rng(13)))
        (small / "pairs.txt").write_text("".join(f"{a} {b}\n" for i, a in enumerate(ids) for b in ids[i + 1:]))
        base = [a for a in predicted["overrides"] if not a.startswith(("predict_folder_path=", "pair_prediction_path=",
                                                                        "trainer.num_devices="))]
        return ([*base, f"predict_folder_path={root / 'wav'}", f"pair_prediction_path={trials}"],
                [*base, "trainer.precision=f32", f"predict_folder_path={small}",
                 f"pair_prediction_path={small / 'pairs.txt'}"], (root / "wav", small))

    def run_world(n: int, backend) -> tuple:
        argv, f32_argv, dirs = folders(f"{backend or 'nccl'}_{n}")
        world = [f"trainer.num_devices={n}"]
        t0 = time.perf_counter()
        (bf16, f32), timing = spawn(
            multi_predict_rank, ([*argv, *world], [*f32_argv, *world], list(predicted["files"]), MP_TIMED),
            nprocs=n, device="cuda", backend=backend, deadline=DP_DEADLINE)
        wall = time.perf_counter() - t0
        scores, pairs = read_scores(pathlib.Path(bf16[0]["path"]))
        f32_scores, _ = read_scores(pathlib.Path(f32[0]["path"]))
        batches = predicted["batches"]
        for records, folder in ((bf16, dirs[0]), (f32, dirs[1])):
            for r in records:
                assert (r["rank"] == 0) == bool(r["saved"]) == (r["path"] is not None) and not (
                    r["rank"] and r["printed"]), f"multi-rank predict rank {r['rank']} wrote {r['saved'][:3]}, " \
                                                 f"{r['path']}, printed {r['printed'][:200]!r}"
            cache = sorted(str(p) for p in (folder / "embeddings").rglob("*.npy"))
            assert sorted(records[0]["saved"]) == cache and cache, \
                f"multi-rank predict: rank 0 saved {len(records[0]['saved'])}, the cache holds {len(cache)}"
        assert [r["launches"] for r in bf16] == [[24 * batches, 6 * batches]] * n, \
            f"multi-rank predict: attention and conv launches a rank {[r['launches'] for r in bf16]}"
        assert pairs == predicted["pairs"], "multi-rank predict: another pair order"
        err = float(np.abs(scores - predicted["scores"]).max())
        f32_err = float(np.abs(f32_scores - predicted["f32_scores"]).max())
        assert err <= MP_SCORE_ATOL and f32_err <= MP_F32_ATOL, f"multi-rank predict: {err}, f32 {f32_err}"
        utt_s = len(predicted["files"]) / float(np.median(timing[0]["warm_s"]))
        return err, f32_err, utt_s, wall, [r["device"] for r in timing]

    err, f32_err, utt_s, wall, devices = run_world(DP_WORLD, "gloo")
    shared = len(set(devices)) == 1
    print(f"multi-rank predict LARGE fused conv bf16, {len(predicted['files'])} files, trainer.num_devices="
          f"{DP_WORLD} on gloo ranks {devices}{' sharing one card' if shared else ''}: scores max diff from 1 rank "
          f"(phase 12) {err:.3e} (limit {MP_SCORE_ATOL}; bit-equal {err == 0}), the same pair order; float32 sub-case "
          f"{f32_err:.3e} (limit {MP_F32_ATOL}); 24 attention forwards and 6 convs a rank a bucket batch "
          f"({predicted['batches']} batches); rank 0 alone saved the cache and the scores and printed; warm utt/s "
          f"(median of {MP_TIMED}, host clock) {utt_s:.2f} against 1 rank's {predicted['utt_s']:.2f}"
          f"{' (two ranks share one card: not a scaling number)' if shared else ''}; the spawned run {wall:.1f} s "
          f"[{card}]", flush=True)
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"multi-rank predict over NCCL not run: {cards} card on this host (a card a rank needs 2 or more)",
              flush=True)
        return
    for n in sorted({2, cards}):
        err, f32_err, utt_s, wall, devices = run_world(n, None)
        print(f"multi-rank predict LARGE fused conv bf16 over NCCL, {n} ranks on {devices}: scores max diff from "
              f"1 rank {err:.3e}, float32 {f32_err:.3e}; warm utt/s {utt_s:.2f} against 1 rank's "
              f"{predicted['utt_s']:.2f}; the spawned run {wall:.1f} s [{card}]", flush=True)


# ------------------------------------------------------------ 39: the CTC kernels

CTC_SPEECH_B, CTC_SPEECH_T = 8, 1199  # phase 16's longest training batch (B x T)
CTC_SPEAKER = (66, 149, 5995)  # phase 17's logits
CTC_OPS_PER_STATE = 3  # a recursion step: two adds and a multiply a state (its alignment not counted)
CTC_TIMED = 20
CTC_ROUTE_STEPS = 3  # timed steps a route, after one warm-up, in the order kernel, F.ctc_loss, F.ctc_loss, kernel


def ctc_inputs(name: str, gen) -> tuple:
    """(lp [B, T, V] float32, frames, labels [B, S] int32, label lengths,
    g [B] the main path's upstream weights: 1 / label length over the
    non-empty rows) on the card. ``speech_train``: phase 16's longest
    batch, 8 rows of 1100-1199 frames and ~12 characters a second of the
    HF letters; ``speaker_ctc``: phase 17's [66, 149, 5995] with one
    speaker a row and the blank's bias of 100; ``ragged``: 5 rows with
    repeated letters, an empty label and an infeasible row."""
    if name == "speech_train":
        b, t, v = CTC_SPEECH_B, CTC_SPEECH_T, 32
        frames = torch.randint(1100, t + 1, (b,), generator=gen, device="cuda")
        frames[0] = t
        lab = (frames.float() * 0.24).to(torch.int64)  # 12 characters a second at 50 frames a second
        logits = torch.randn(b, t, v, generator=gen, device="cuda")
        low = 5  # the HF vocabulary's letters
    elif name == "speaker_ctc":
        b, t, v = CTC_SPEAKER
        frames = torch.full((b,), t, device="cuda")
        lab = torch.ones(b, dtype=torch.int64, device="cuda")
        logits = torch.randn(b, t, v, generator=gen, device="cuda")
        logits[..., 0] += 100.0
        low = 1
    elif name == "long_labels":  # 2201 states: two pairs of states a thread
        b, t, v = 2, 2300, 32
        frames = torch.tensor([2300, 2250], device="cuda")
        lab = torch.tensor([1100, 1050], device="cuda")
        logits = torch.randn(b, t, v, generator=gen, device="cuda")
        low = 5
    else:
        b, t, v = 5, 300, 32
        frames = torch.tensor([300, 251, 120, 40, 5], device="cuda")
        lab = torch.tensor([110, 70, 61, 0, 8], device="cuda")
        logits = 2 * torch.randn(b, t, v, generator=gen, device="cuda")
        low = 5
    s = int(lab.max())
    labels = torch.randint(low, v, (b, s), generator=gen, device="cuda", dtype=torch.int32)
    if name == "ragged":
        labels[0, 1::5] = labels[0, 0:-1:5]  # repeated letters
    labels *= (torch.arange(s, device="cuda")[None] < lab[:, None]).to(torch.int32)
    valid = (lab > 0).float()
    g = valid / lab.clamp_min(1).float() / valid.sum()
    return (torch.log_softmax(logits, -1), frames.to(torch.int32), labels, lab.to(torch.int32), g)


def ctc_bounds(lp, frames, labels, label_lens) -> dict:
    """Per kernel (bound ms, 'bytes' | 'operations') for this data (H100 SXM:
    3.35 TB/s, 34 TFLOP/s float64 outside the tensor cores), counting only
    what the function needs: each chain reads a row's log-probabilities
    once, the fewer of its T_b x V (a vocabulary row a frame) and T_b x
    S'_b (the gathered lp[t, l'_s]) float32s, and the labels and lengths;
    the forward writes logp; the backward reads lp at each row's frames,
    logp and g, and writes the gradient [B, T, V] (float32).
    ``CTC_OPS_PER_STATE`` operations a state and frame a chain, and in the
    backward an occupancy product and add a state and frame and an exp, a
    subtract and a multiply a (frame, v). Also "chain", the longest row's
    frames (the chain of dependent steps each pass runs), and "traffic_ms",
    this design's own alpha and beta (16-byte (m, k) pairs a state) at the
    card's memory rate, which the forward writes and the backward reads
    again: a cost of the design, not of the function, so it is printed
    beside the bound and not in it."""
    b, t, v = lp.shape
    states = 2 * label_lens.double() + 1
    cells = float((frames.double() * states).sum())
    read = 4 * float((frames.double() * torch.clamp(states, max=v)).sum())  # a chain's lp read
    frames_v = float(frames.double().sum()) * v
    small = 4 * (labels.numel() + 2 * b)
    ops = CTC_OPS_PER_STATE * cells  # a chain's
    work = {
        "ctc_alpha_beta": (2 * read + small + 8 * b, 2 * ops),
        "ctc_grad": (4 * frames_v + small + 16 * b + 4 * b * t * v, 3 * cells + 3 * frames_v),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        b_ms, o_ms = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_OPS[torch.float64]
        out[name] = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")
    out["chain"] = int(frames.max())
    out["traffic_ms"] = 1e3 * 2 * 16 * cells / PEAK_BYTES
    return out


def ctc_case(name: str, gen) -> dict:
    """Phase 39 (a) at one shape: the forward (``ctc_alpha_beta``, one
    launch of both chains) and the backward (``ctc_grad``) against their
    plain versions (``ctc.kernel_tolerance``: loss relative on feasible
    rows, the logit gradient absolute), exact zeros on infeasible rows and
    past each row's frames, two launches bit-equal, one launch a call; then
    each kernel's, its plain version's, its bound's and ``F.ctc_loss``'s
    (forward; backward on a kept graph) ms, and the chains' us a frame of
    the longest row. Returns the kernels line's rows and the report."""
    lp, frames, labels, label_lens, g = ctc_inputs(name, gen)
    rtol, gatol = ctc.kernel_tolerance()
    reset_ctc_launches()
    alpha, beta, logp = ctc.ctc_alpha_beta(lp, frames, labels, label_lens)
    grad = ctc.ctc_grad(lp, alpha, beta, logp, g, frames, labels, label_lens)
    alpha2, beta2, logp2 = ctc.ctc_alpha_beta(lp, frames, labels, label_lens)
    grad2 = ctc.ctc_grad(lp, alpha2, beta2, logp2, g, frames, labels, label_lens)
    torch.cuda.synchronize()
    assert ctc_launches() == {"ctc_alpha_beta": 2, "ctc_grad": 2}, ctc_launches()
    assert torch.equal(logp, logp2) and torch.equal(grad, grad2), f"ctc {name}: two launches differ"
    b, t, v = lp.shape
    want_alpha, want_logp = ctc.ctc_alpha_reference(lp, frames, labels, label_lens)
    want_beta = ctc.ctc_beta_reference(lp, frames, labels, label_lens)
    want = ctc.ctc_grad_reference(lp, want_alpha, want_beta, want_logp, g, frames, labels, label_lens)
    feasible = torch.isfinite(want_logp)
    assert torch.equal(torch.isfinite(logp), feasible), f"ctc {name}: feasible rows {logp} vs {want_logp}"
    loss_err = float(((logp - want_logp).abs() / want_logp.abs().clamp_min(1e-30))[feasible].max())
    logp_abs = float((logp - want_logp).abs()[feasible].max())
    grad_err = float((grad - want).abs().max())
    frames_ok = torch.arange(t, device="cuda")[None, :] < frames[:, None]
    zeros = bool(torch.all(grad[~frames_ok] == 0) and torch.all(grad[~feasible] == 0))
    assert loss_err <= rtol and grad_err <= gatol and zeros, \
        f"ctc {name}: loss rel {loss_err}, grad abs {grad_err}, exact zeros {zeros}"
    if name == "ragged":
        assert feasible.tolist() == [True, True, True, True, False], f"ctc ragged: feasible {feasible.tolist()}"
    bounds = ctc_bounds(lp, frames, labels, label_lens)
    args = (frames, labels, label_lens)
    leaf = lp.detach().requires_grad_()
    lib = F.ctc_loss(leaf.transpose(0, 1), labels.long(), frames.long(), label_lens.long(), reduction="none",
                     zero_infinity=True)
    lib_total = (lib * g).sum()

    def lib_forward():
        return F.ctc_loss(lp.transpose(0, 1), labels.long(), frames.long(), label_lens.long(), reduction="none",
                          zero_infinity=True)

    def plain_forward():
        ctc.ctc_alpha_reference(lp, *args)
        ctc.ctc_beta_reference(lp, *args)

    lib_fwd = cuda_ms(lib_forward, CTC_TIMED)
    times = {
        "ctc_alpha_beta": (cuda_ms(lambda: ctc.ctc_alpha_beta(lp, *args), CTC_TIMED),
                           cuda_ms(plain_forward, 2, warmup=1), lib_fwd),
        "ctc_grad": (cuda_ms(lambda: ctc.ctc_grad(lp, alpha, beta, logp, g, *args), CTC_TIMED),
                     cuda_ms(lambda: ctc.ctc_grad_reference(lp, want_alpha, want_beta, want_logp, g, *args), 2,
                             warmup=1),
                     backward_ms(lib_total, [leaf], torch.ones((), device="cuda"), CTC_TIMED)),
    }
    rows = {k: {"max_abs_err": grad_err if k == "ctc_grad" else logp_abs, "ms": ms, "plain_ms": plain,
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": lib_ms}
            for k, (ms, plain, lib_ms) in times.items()}
    step = rows["ctc_alpha_beta"]["ms"] + rows["ctc_grad"]["ms"]
    lib_step = lib_fwd + rows["ctc_grad"]["library_ms"]
    report = (f"ctc {name} B={b} T={t} V={v} S={labels.shape[1]}: feasible rows {int(feasible.sum())}/{b}, loss rel "
              f"{loss_err:.2e} (limit {rtol}), logit gradient abs {grad_err:.2e} (limit {gatol}), exact zeros past "
              f"the frames and on infeasible rows, two launches bit-equal; launches a call: forward 1 (alpha and "
              f"beta chains), backward 1; " + "; ".join(
                  f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.5f} by {r['bound_by']}, "
                  f"F.ctc_loss {'backward' if k == 'ctc_grad' else 'forward'} {r['library_ms']:.4f})"
                  for k, r in rows.items())
              + f"; alpha and beta, written by the forward and read by the backward, {bounds['traffic_ms']:.4f} ms "
              f"each way at the memory rate"
              + f"; training step forward + backward {step:.4f} ms against F.ctc_loss {lib_step:.4f}; the chains "
              f"of the longest row's {bounds['chain']} frames, alpha and beta side by side: "
              f"{1e3 * rows['ctc_alpha_beta']['ms'] / bounds['chain']:.3f} us a frame")
    return rows, report


def ctc_route_steps(card: str) -> None:
    """Phase 39 (c): the speech recipe's step (BASE, 12 layers, bf16) at
    phase 16's longest batch, its CTC through the kernels and through
    ``F.ctc_loss`` (the route before them), in the order kernel, F.ctc_loss,
    F.ctc_loss, kernel, ``CTC_ROUTE_STEPS`` timed steps each after one
    warm-up; the kernel route's launches."""
    from w2v2_speaker_tpu_torch.objectives import losses

    cfg = load_recipe("speech_wav2vec2_ctc")
    tok = CharTokenizer.wav2vec2_base_960h()
    dev = torch.device("cuda")
    with torch.device("meta"):
        model = Wav2Vec2SpeechModel(speech_model_config(cfg, tok.vocab_size))
    model.to_empty(device=dev)
    init_parameters(model, torch.Generator(device=dev).manual_seed(16))
    state = TrainState.create(model, build_optimizer(cfg), seed=1)
    step = make_train_step(SpeechTask(model, tok))
    rng = np.random.default_rng(39)
    samples = 384000  # 24 s: 1199 frames
    lengths = np.sort(rng.integers(352000, samples + 1, CTC_SPEECH_B))[::-1].copy()
    lengths[0] = samples
    mask = np.arange(samples)[None, :] < lengths[:, None]
    lab = np.array([int(feat_extract_output_lengths(int(n)) * 0.24) for n in lengths], np.int32)
    labels = np.zeros((CTC_SPEECH_B, lab.max()), np.int32)
    for i, n in enumerate(lab):
        labels[i, :n] = rng.integers(5, tok.vocab_size, n)
    batch = {"features": torch.from_numpy((rng.normal(0, 0.1, mask.shape) * mask).astype(np.float32)).to(dev),
             "mask": torch.from_numpy(mask).to(dev), "labels": torch.from_numpy(labels).to(dev),
             "label_lengths": torch.from_numpy(lab).to(dev)}
    kernel_rows = losses.ctc_loss_rows

    def library_rows(logits, frames, labels, label_lengths, blank=0):
        return F.ctc_loss(F.log_softmax(logits.float(), -1).transpose(0, 1), labels.long(), frames.long(),
                          label_lengths.long(), blank=blank, reduction="none", zero_infinity=True)

    timed = {"kernel": [], "F.ctc_loss": []}
    launched = None
    try:
        for route in ("kernel", "F.ctc_loss", "F.ctc_loss", "kernel"):
            losses.ctc_loss_rows = kernel_rows if route == "kernel" else library_rows
            state, _ = step(state, batch)  # warm-up
            reset_ctc_launches()
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CTC_ROUTE_STEPS):
                state, metrics = step(state, batch)
            stop.record()
            torch.cuda.synchronize()
            timed[route].append(start.elapsed_time(stop) / CTC_ROUTE_STEPS)
            if route == "kernel":
                launched = ctc_launches()
                assert launched == {"ctc_alpha_beta": CTC_ROUTE_STEPS, "ctc_grad": CTC_ROUTE_STEPS}, launched
            else:
                assert not any(ctc_launches().values()), ctc_launches()
            assert torch.isfinite(metrics["loss"]), f"ctc route {route}: loss {metrics['loss']}"
    finally:
        losses.ctc_loss_rows = kernel_rows
    print(f"speech step BASE bf16 at phase 16's longest batch ({CTC_SPEECH_B} x {int(mask.sum(1).max())} samples, "
          f"labels {lab.tolist()}): ms/step (CUDA events, {CTC_ROUTE_STEPS} steps a turn) through the CTC kernels "
          f"{[round(x, 2) for x in timed['kernel']]}, through F.ctc_loss {[round(x, 2) for x in timed['F.ctc_loss']]} "
          f"(turns kernel, F.ctc_loss, F.ctc_loss, kernel); kernel launches a step {launched} / {CTC_ROUTE_STEPS} "
          f"[{card}]", flush=True)


def ctc_kernel_phase(card: str) -> dict:
    """Phase 39 (a) and (c); returns the kernels line's rows (phase 16's
    longest training batch)."""
    gen = torch.Generator(device="cuda").manual_seed(39)
    main_rows = None
    for name in ("speech_train", "speaker_ctc", "ragged", "long_labels"):
        rows, report = ctc_case(name, gen)
        print(report + f" [{card}]", flush=True)
        if name == "speech_train":
            main_rows = rows
    ctc_route_steps(card)
    return main_rows


def ctc_deterministic_phase(card: str, tmp: pathlib.Path, wav_dir, trials, shards) -> None:
    """Phase 39 (b): the three CTC recipes, 4 steps each at full BASE width
    on phases 16-18's data, under ``trainer.deterministic=true`` in two
    fresh processes (each running the three in turn): losses and final
    parameters bit-equal; ms/step beside the same runs without the flag in
    a third."""
    import os

    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    common = [f"trainer.fast_dev_run={DET_STEPS}", "eval_model=false", "trainer.log_dir=null", ONE_RANK]
    recipes = [
        ("speech_wav2vec2_ctc", ["+experiment=speech_wav2vec2_ctc", *speech_args(tmp), "seed=16"]),
        ("speaker_wav2vec2_ctc", ["+experiment=speaker_wav2vec2_ctc", f"data.shards.samples_per_shard={RUN_SHARD}",
                                  "seed=17", *corpus_args(wav_dir, trials, shards, tmp / "ctc_det_ckpt")]),
        ("multitask_wav2vec2", ["+experiment=multitask_wav2vec2", *mt_args(tmp), "seed=16"]),
    ]

    def runs(flag: str) -> list:
        return [(label, [*argv, *common, f"trainer.deterministic={flag}",
                         *([] if "trainer.checkpoint_dir" in " ".join(argv) else
                           [f"trainer.checkpoint_dir={tmp / 'ctc_det' / label}"])]) for label, argv in recipes]

    t0 = time.perf_counter()
    a, b = deterministic_pair(tmp, "ctc_det", runs("true"), env)
    nondet = run_child(tmp, "ctc_nondet", runs("false"), env)
    report = []
    for label, _ in recipes:
        ra = a["runs"][label]
        assert len(ra["losses"]) == DET_STEPS, f"deterministic {label}: {len(ra['losses'])} steps"
        report.append(f"{label}: losses {[round(float.fromhex(x), 4) for x in ra['losses']]} and "
                      f"{len(ra['params'])} parameters bit-equal, ms/step {step_ms(ra):.2f} and "
                      f"{step_ms(b['runs'][label]):.2f} against {step_ms(nondet['runs'][label]):.2f} without the flag")
    print(f"deterministic CTC recipes, {DET_STEPS} steps each in two fresh processes (CUDA events, the steps after "
          f"the first; {time.perf_counter() - t0:.1f} s with a third process without the flag): "
          + "; ".join(report) + f" [{card}]", flush=True)


# ------------------------------------------------ 40: the float32 BASE training path
F32_DISPATCHES = 2  # timed dispatches of the recipe's 4 steps


def layer0_backward(step, state, batch) -> dict:
    """One more dispatch of ``step`` with layer 0's attention backward
    recorded: q, k, v, its upstream gradient, lengths, rate and seed from
    the dispatch's last step that kept layer 0 (its q is the first view of
    that layer's fused projection, whose output a forward hook notes)."""
    attn = state.model.wav2vec2.encoder.layers[0].attention
    noted, kept = {}, {}
    bwd = fa.flash_attention_bwd

    def note(module, args, out):
        if torch.is_grad_enabled():
            noted["ptr"] = out.data_ptr()

    def record(q, k, v, o, do, lse, lengths=None, dropout_rate=0.0, seed=None, coords=(0, 0, 0)):
        if q.data_ptr() == noted.get("ptr"):
            kept.update(q=q, k=k, v=v, do=do.to(q.dtype).contiguous(), lengths=lengths, rate=dropout_rate,
                        seed=seed)
        return bwd(q, k, v, o, do, lse, lengths, dropout_rate, seed, coords)

    handle = attn.qkv_proj.register_forward_hook(note)
    fa.flash_attention_bwd = record
    try:
        step(state, batch)
        torch.cuda.synchronize()
    finally:
        fa.flash_attention_bwd = bwd
        handle.remove()
    assert kept, "no step of the dispatch kept layer 0"
    return kept


def f32_recipe_phase(card: str) -> dict:
    """Phase 40: ``speaker_wav2vec2_ce`` with ``trainer.precision=f32`` at
    full BASE width through the recipe entry (``_recipe_entry``, B=66 x
    ``SAMPLES``, 4 steps a dispatch): ``train_phase``'s warm-up, then
    ``F32_DISPATCHES`` timed dispatches, each float32 attention kernel
    launched once a kept layer in every step (no conv kernel: BASE takes
    cuDNN's route), finite losses, the parameters moved, ms/step, peak
    memory and one profiled dispatch's device ms by category (the attention
    backward's among them); then layer 0's q/k/v and upstream gradient from
    a training step through the forward and the dq + dk/dv pair against
    their plain versions, repeated bit for bit and within the float64 rule.
    Returns each kernel's launches over the timed steps."""
    cfg = load_recipe("speaker_wav2vec2_ce", ["trainer.precision=f32"])
    checked = {}

    def check(step, state, batch):
        rec = layer0_backward(step, state, batch)
        lens = rec["lengths"]
        b, t = rec["q"].shape[:2]
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda") if lens is None else lens
        errors, _, _ = attention_pair_errors(rec["q"], rec["k"], rec["v"], lens, rec["rate"], rec["seed"],
                                             rec["do"])
        for out, (err, share, zeros) in errors.items():
            assert share <= 1 and zeros, f"f32 train attention {out}: err {err}, {share:.3f} of the limit"
        checked["summary"] = (f"layer 0 B={b} T={t} float32 rate {rec['rate']} seed {rec['seed']}, the step's "
                              "own upstream gradient: " + ", ".join(
                                  f"{out} {share:.3f}" for out, (_, share, _) in errors.items()) + " of the limits")

    total = train_phase(card, lambda: _recipe_entry(cfg, None, 66, SAMPLES), "f32 train",
                        dispatches=F32_DISPATCHES, after=check)
    print(f"f32 train attention vs plain: {checked['summary']} [{card}]", flush=True)
    return total


class Lap:
    """Prints the wall seconds (host clock) since the last lap under a
    phase's label, so that a run near its time limit shows where the time
    went."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        print(f"phase_s {label} {now - self.t:.1f}", flush=True)
        self.t = now


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs a card")
    t_start = time.perf_counter()
    lap = Lap()

    card = card_line()  # 1
    print(card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    set_float32_precision()  # full f32 for the plain versions and the yardsticks
    build_phase()  # 2
    lap("2")
    main_rows = kernel_phase()  # 3
    lap("3")
    serving_phase(card)  # 4, 5
    lap("4-5")
    train_phase(card)  # 6
    lap("6")
    f32_train_phase()  # 7
    overfit_phase()  # 8
    lap("7-8")
    large_serving_phase(card)  # 9
    lap("9")
    train_launches = train_phase(card, large_train_entry, "large train", conv_per_step=6)  # 10
    lap("10")
    large = load_recipe("speaker_wav2vec2_large_aam", ["network.conv_impl=fused_pallas"])
    f32_launches = f32_train_phase(large, "LARGE", conv_launches=6)  # 11
    lap("11")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        predicted = predict_phase(card, tmp)  # 12
        lap("12")
        wav_dir, trials, shards = run_phase(card, tmp)  # 13
        lap("13")
        corpus = (card, tmp, wav_dir, trials, shards)
        for phase, args in (
            (pairs_phase, corpus[:4]),  # 14
            (pooling_phase, corpus),  # 15
            (speech_phase, corpus[:2]),  # 16
            (speaker_ctc_phase, corpus),  # 17
            (multitask_phase, corpus[:2]),  # 18
            (triplet_phase, corpus[:2]),  # 19
            (options_phase, corpus),  # 20
            (fbank_phase, corpus[:1]),  # 21
            (xvector_phase, corpus),  # 22
            (ecapa_phase, corpus),  # 23
            (wav2spk_dummy_phase, corpus),  # 24
            (dsp_phase, corpus[:1]),  # 25
            (augment_phase, corpus),  # 26
            (augmented_base_phase, corpus),  # 27
            (wav2vec1_phase, corpus),  # 28
            (optim_phase, corpus),  # 29 (a)-(c)
            (mu_dtype_phase, corpus[:1]),  # 29 (d)
            (lr_find_phase, corpus),  # 30
            (tracker_phase, corpus),  # 31
            (surface_phase, corpus),  # 32
        ):
            phase(*args)
            free_checkpoints(tmp)
            lap(phase.__name__)
        main_rows.update(int8_kernel_phase(card, predicted))  # 33
        lap("33")
        run_args = ["+experiment=speaker_wav2vec2_ce", f"data.shards.samples_per_shard={RUN_SHARD}", "seed=13",
                    *corpus_args(wav_dir, trials, shards, tmp / "ckpt")]
        path_launches = {**train_launches, **int8_serving_phase(card, tmp, predicted, run_args)}  # 34
        lap("34")
        knobs_phase(card, tmp, wav_dir, trials, shards)  # 35
        free_checkpoints(tmp)
        lap("35")
        offset_kernel_phase(card)  # 36 (a): data parallelism
        dp_run_phase(card, tmp, wav_dir, trials, shards)
        dp_f32_phase(card)
        lap("36")
        tp_phase(card)  # 37 (b): tensor parallelism
        lap("37")
        multi_predict_phase(card, tmp, predicted)  # 38
        lap("38")
        main_rows.update(ctc_kernel_phase(card))  # 39 (a), (c)
        lap("39 a, c")
        ctc_deterministic_phase(card, tmp, wav_dir, trials, shards)  # 39 (b)
        lap("39 b")
        path_launches.update(MEASURED["speech_ctc_launches"])
    f32_path = f32_recipe_phase(card)  # 40
    lap("40")
    path_launches.update({f"{name}_f32": n for name, n in f32_path.items() if name in ATTENTION})
    path_launches["conv_encoder_f32"] = f32_launches["conv_encoder"]

    # 41. kernels line, card line, result line: the attention kernels' and
    # the conv's launches from the LARGE training run (phase 10), the int8
    # kernels' from the LARGE int8 predict run (phase 34), the CTC kernels'
    # from the speech run (phase 16); the float32 attention kernels' from
    # the float32 BASE training run (phase 40), the float32 conv's from the
    # float32 LARGE step (phase 11)
    kernels = []
    for name, source, replaces in KERNELS + KERNELS_F32:
        row = main_rows[name]
        assert path_launches[name] > 0, f"{name} was not launched on its main path"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"w2v2_speaker_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": path_launches[name],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        })
    print(f"chip_smoke total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
