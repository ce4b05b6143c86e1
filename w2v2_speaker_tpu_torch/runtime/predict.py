"""Serving: bucketed embedding extraction and pair scoring, end to end.

Counterparts:

- ``extract_embeddings`` <- ``w2v2_speaker_tpu/runtime/experiment.py::
  extract_embeddings`` (:742): sort by length, right-pad each batch to a
  multiple of ``pad_to_multiple`` samples, pad the last batch with
  all-invalid rows, run the masked model, slice the rows back; a frame-level
  model's ``[T, D]`` embeddings come back unpooled, with every frame of the
  padded batch, and with ``num_ensembles`` each sample holds its list of
  per-layer embeddings;
- ``read_pair_file`` <- ``w2v2_speaker_tpu/runtime/predict.py::
  read_pair_file`` (:74);
- ``run_predictions`` <- ``w2v2_speaker_tpu/runtime/predict.py::
  run_predictions`` (:85): the pair file's sorted unique ids, the
  configured evaluator, the ``wav2vec2_fc`` or ``wav2vec2_multitask``
  model (whose speaker branch embeds), or the x-vector, ECAPA-TDNN,
  wav2spk, dummy or wav2vec v1 (``wav2vec_fc``, ``wav2vec_xvector``) model,
  with its weights
  (``network.pretrained_checkpoint``, then ``load_network_from_checkpoint``),
  16 kHz audio read and normalised per utterance, embeddings cached as
  ``<folder>/embeddings/<id>.npy``, AS-Norm fitted on the extraction set,
  scores mapped to (s + 1) / 2, clipped to [0, 1] and written as
  ``<pairs-stem>_scores.txt`` lines ``<score> <a> <b>``.

Differences from the JAX package: no optimizer is built (serving needs
none), there is no mesh (one card), ``network.int8_matmuls`` other than
false and raises (``BucketDispatchEmbed`` waits for ROADMAP.md Queue 1 item 6).
In bf16 the model keeps float32 parameters and computes under autocast, as
the JAX package's model keeps float32 parameters and computes in bf16.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.collate import collate_pad_right, pad_batch_rows
from ..data.io import load_raw_audio
from ..data.normalize import normalize_waveform
from ..data.samples import SpeakerSample
from ..device import DeviceLike, resolve_device, set_float32_precision
from ..eval.evaluator import ASNormCosineEvaluator, EmbeddingSample
from ..models.wav2vec2 import init_parameters
from ..train.checkpoint import load_params
from .experiment import _canon_int8, build_evaluator, build_model_and_task, graft_pretrained

__all__ = ["build_predict_model", "extract_embeddings", "read_pair_file", "run_predictions"]


@torch.inference_mode()
def extract_embeddings(
    model,
    samples: Sequence[SpeakerSample],
    pad_to_multiple: int = 16000,
    batch_size: int = 8,
    device: DeviceLike = None,
    num_ensembles: Optional[int] = None,
) -> List[EmbeddingSample]:
    """Batched, bucketed, masked embedding extraction with
    ``model.compute_embedding(wav, mask)``, or, given ``num_ensembles``,
    ``model.compute_ensemble_embeddings(wav, mask, num_ensembles)`` (each
    sample's embedding then a list of one ``[D]`` per layer; the layers are
    pooled on the device, and only the pooled rows come to the host). A
    frame-level embedding ``[T, D]`` holds every frame of its padded batch,
    as the JAX package's does. ``model`` must already live on ``device``
    (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    out: List[EmbeddingSample] = []
    samples = sorted(samples, key=lambda s: s.wav.shape[-1])
    for i in range(0, len(samples), batch_size):
        chunk = samples[i : i + batch_size]
        batch = collate_pad_right(
            [s.wav for s in chunk], pad_to_multiple=pad_to_multiple, dtype=np.float32
        )
        padded = pad_batch_rows({"features": batch.values, "mask": batch.mask}, batch_size)
        wav = torch.from_numpy(padded["features"]).to(dev)
        mask = torch.from_numpy(padded["mask"]).to(dev)
        if num_ensembles is not None:
            layers = [e.float().cpu().numpy() for e in model.compute_ensemble_embeddings(wav, mask, num_ensembles)]
            out.extend(EmbeddingSample(s.key, [lay[j] for lay in layers]) for j, s in enumerate(chunk))
        else:
            embs = model.compute_embedding(wav, mask).float().cpu().numpy()
            out.extend(EmbeddingSample(s.key, embs[j]) for j, s in enumerate(chunk))
    return out


def read_pair_file(path: pathlib.Path) -> List[Tuple[str, str]]:
    """Trial pairs from ``<label> <a> <b>`` or ``<a> <b>`` lines."""
    pairs = []
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.strip().split(" ")
        if len(parts) == 3:
            pairs.append((parts[1], parts[2]))
        elif len(parts) == 2:
            pairs.append((parts[0], parts[1]))
    return pairs


def _check_servable(cfg: Dict) -> None:
    """Raise for what predict cannot serve: a network without a speaker
    embedding (the speech and paired networks; the JAX package raises
    too), int8 matmuls, and what ``build_model_and_task`` refuses (a
    loss the network does not take, x-vector or wav2spk under AAM), built
    on the meta device."""
    name = cfg["network"].get("name")
    if name in ("wav2vec2_fc_letter", "wav2vec2_paired"):
        raise ValueError("predict supports speaker (or multitask) models")
    int8 = cfg["network"].get("int8_matmuls", False)
    if _canon_int8(int8) is not False:
        raise NotImplementedError(
            f"network.int8_matmuls={int8!r} is not ported yet: ROADMAP.md Queue 1 item 6 (int8 serving)"
        )
    with torch.device("meta"):
        build_model_and_task(cfg, cfg["network"].get("explicit_num_speakers") or 2)


def build_predict_model(cfg: Dict, device: DeviceLike = None):
    """The eval-mode speaker model of ``cfg`` on ``device``: parameters
    drawn from ``cfg["seed"]`` on the device, then ``graft_pretrained``,
    then ``load_network_from_checkpoint`` grafted into the whole model
    (leaves of another shape keep their values, as the JAX package's
    ``_init_state`` :983-1004 does). Parameters stay float32."""
    dev = resolve_device(device)
    net = cfg["network"]
    if dev.type == "cuda":
        set_float32_precision()
    with torch.device("meta"):
        task, _ = build_model_and_task(cfg, net.get("explicit_num_speakers") or 2)
    model = task.model.to_empty(device=dev)
    init_parameters(model, torch.Generator(device=dev).manual_seed(int(cfg["seed"])))
    graft_pretrained(model, net)
    if cfg.get("load_network_from_checkpoint"):
        load_params(cfg["load_network_from_checkpoint"], model)
    return model.eval().requires_grad_(False)


def run_predictions(cfg: Dict, device: DeviceLike = None) -> pathlib.Path:
    """Score ``cfg["pair_prediction_path"]`` over the audio under
    ``cfg["predict_folder_path"]``; returns the score file's path. Runs on
    the card unless ``device="cpu"``; raises without a card before it
    reads anything."""
    dev = resolve_device(device)
    folder = pathlib.Path(cfg["predict_folder_path"])
    pair_file = pathlib.Path(cfg["pair_prediction_path"])
    pairs = read_pair_file(pair_file)
    id_list = sorted({p for pair in pairs for p in pair})
    print(f"{len(pairs)} pairs over {len(id_list)} files")

    evaluator = build_evaluator(cfg)
    _check_servable(cfg)

    emb_dir = folder / "embeddings"
    emb_dir.mkdir(exist_ok=True, parents=True)
    todo: List[SpeakerSample] = []
    cached: Dict[str, np.ndarray] = {}
    for name in id_list:
        cache = emb_dir / (name + ".npy")
        if cache.exists():
            cached[name] = np.load(cache)
            continue
        wav = normalize_waveform(load_raw_audio(folder / name))
        todo.append(SpeakerSample(key=name, wav=wav, ground_truth=-1))

    if todo:
        print(f"computing {len(todo)} speaker embeddings")
        model = build_predict_model(cfg, dev)
        dl = cfg["data"]["dataloader"]
        fresh = extract_embeddings(
            model, todo,
            pad_to_multiple=dl.get("test_pad_to_multiple", 16000),
            batch_size=dl.get("test_batch_size", 8),
            device=dev,
        )
        for s in fresh:
            out = emb_dir / (s.sample_id + ".npy")
            out.parent.mkdir(exist_ok=True, parents=True)
            np.save(out, s.embedding)
            cached[s.sample_id] = np.asarray(s.embedding)

    embedding_pairs = [(EmbeddingSample(a, cached[a]), EmbeddingSample(b, cached[b])) for a, b in pairs]
    if isinstance(evaluator, ASNormCosineEvaluator):
        # the extraction set is the impostor cohort (each side's exact twin
        # is excluded from its top-K inside _cohort_stats)
        evaluator.fit_parameters(list(cached.values()))
    scores = np.asarray(evaluator._compute_prediction_scores(embedding_pairs))
    scores = np.clip((scores + 1) / 2, 0, 1)

    score_file = pair_file.parent / f"{pair_file.stem}_scores.txt"
    with open(score_file, "w") as f:
        for s, (a, b) in zip(scores.tolist(), pairs):
            f.write(f"{s} {a} {b}\n")
    print(f"wrote {score_file}")
    return score_file
