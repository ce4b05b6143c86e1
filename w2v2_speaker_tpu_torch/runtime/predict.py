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
  ``<pairs-stem>_scores.txt`` lines ``<score> <a> <b>``;
- ``BucketDispatchEmbed`` <- ``w2v2_speaker_tpu/runtime/predict.py::
  BucketDispatchEmbed`` (:42): ``network.int8_matmuls=auto`` routes each
  bucket batch to int8 or to full precision by ``ops.quant.int8_auto_policy``
  (threshold ``network.int8_auto_min_samples``) and prints ``int8 auto
  dispatch: n/m bucket batches on int8 (threshold ... samples)``, as
  :158-163; ``network.int8_matmuls=true`` serves every bucket in int8.
  The threshold is the TPU's crossover: on an H100 int8 is slower than
  bf16 at every shape measured (PERF.md §5), so ``auto`` serves slower.

``run_predictions`` reads ``trainer.num_devices`` with the run twin's
world rules (``parallel/mesh.py``): N > 1 ranks (``all``: every card, 1 on
the CPU) in the process group that exists (a caller's or torchrun's), else
in N ranks spawned here (NCCL with a card a rank on the card, gloo on the
CPU); more ranks than cards raise before anything is read. Each rank builds
the same model from the same seed and checkpoint on its own card; rank 0
alone reads and normalises the audio, each sample reaching the other ranks
by broadcast (``shared_iter``), as the JAX package's mesh (``create_mesh()``
over every local device, :102) reads it once on its one host; each bucket
batch, its rows padded to a multiple of the data ranks (:755), is sharded
over them and gathered (``extract_embeddings``). Every rank sees the same
padded width, so ``BucketDispatchEmbed`` routes every rank's shard of a
batch alike. Rank 0 alone writes the cache and the scores and prints.

Differences from the JAX package: no optimizer is built (serving needs
none). Under ``auto`` both arithmetics read
one model: its dense sites are ``QuantLinear``s, switched per bucket batch
(``ops.quant.int8_enabled``), where the JAX package builds a second
program over the same parameters. In bf16 the model keeps float32
parameters and computes under autocast, as the JAX package's model keeps
float32 parameters and computes in bf16.
"""

from __future__ import annotations

import contextlib
import copy
import io
import pathlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.collate import collate_pad_right, pad_batch_rows
from ..data.io import load_raw_audio
from ..data.normalize import normalize_waveform
from ..data.samples import SpeakerSample
from ..device import DeviceLike, resolve_device, set_float32_precision
from ..eval.evaluator import ASNormCosineEvaluator, EmbeddingSample
from ..models.wav2vec2 import init_parameters
from ..parallel.mesh import (Mesh, check_cards, create_mesh, needs_spawn, resolve_num_devices, shard_map_rows,
                             shared_iter, spawn)
from ..ops.quant import INT8_AUTO_MIN_SAMPLES, int8_auto_policy, int8_enabled
from ..train.checkpoint import load_params
from .experiment import _canon_int8, build_evaluator, build_model_and_task, graft_pretrained

__all__ = ["BucketDispatchEmbed", "build_predict_model", "extract_embeddings", "read_pair_file",
           "run_predictions"]


class BucketDispatchEmbed:
    """Per-bucket full-precision / int8 embedding (``network.int8_matmuls=auto``).

    ``extract_embeddings`` pads each bucket batch to a multiple of
    ``test_pad_to_multiple`` samples; each call routes its batch by
    ``int8_auto_policy(padded samples, hidden_size, min_samples)`` to
    ``embed_int8`` or ``embed_full`` (each ``(wav, mask) -> embeddings``)
    and records ``(padded samples, used int8)`` in ``calls``. It stands in
    for the model in ``extract_embeddings`` (``compute_embedding``)."""

    def __init__(self, embed_full: Callable, embed_int8: Callable, hidden_size: int,
                 min_samples: int = INT8_AUTO_MIN_SAMPLES):
        self._full, self._int8 = embed_full, embed_int8
        self.hidden_size, self.min_samples = hidden_size, min_samples
        self.calls: List[Tuple[int, bool]] = []

    def __call__(self, wav, mask=None):
        use_int8 = int8_auto_policy(int(wav.shape[-1]), self.hidden_size, self.min_samples)
        self.calls.append((int(wav.shape[-1]), use_int8))
        return (self._int8 if use_int8 else self._full)(wav, mask)

    compute_embedding = __call__


def dispatch_embed(model, cfg: Dict) -> BucketDispatchEmbed:
    """The ``BucketDispatchEmbed`` of ``model`` (built with int8 sites):
    both routes run the same model, its ``QuantLinear``s switched per
    call."""

    def route(enabled: bool):
        def embed(wav, mask=None):
            int8_enabled(model, enabled)
            return model.compute_embedding(wav, mask)
        return embed

    return BucketDispatchEmbed(route(False), route(True), hidden_size=model.cfg.w2v2.hidden_size,
                               min_samples=int(cfg["network"].get("int8_auto_min_samples", INT8_AUTO_MIN_SAMPLES)))


@torch.inference_mode()
def extract_embeddings(
    model,
    samples: Sequence[SpeakerSample],
    pad_to_multiple: int = 16000,
    batch_size: int = 8,
    device: DeviceLike = None,
    num_ensembles: Optional[int] = None,
    mesh=None,
) -> List[EmbeddingSample]:
    """Batched, bucketed, masked embedding extraction with
    ``model.compute_embedding(wav, mask)``, or, given ``num_ensembles``,
    ``model.compute_ensemble_embeddings(wav, mask, num_ensembles)`` (each
    sample's embedding then a list of one ``[D]`` per layer; the layers are
    pooled on the device, and only the pooled rows come to the host). A
    frame-level embedding ``[T, D]`` holds every frame of its padded batch,
    as the JAX package's does. ``model`` must already live on ``device``
    (the card unless ``device="cpu"``). With a ``mesh`` (``parallel.mesh``)
    of more than one data rank, ``batch_size`` is rounded up to a multiple
    of the data ranks and each batch's rows are sharded over them and
    gathered (as the JAX package's ``extract_embeddings`` :742-780 with
    ``num_devices``)."""
    dev = resolve_device(device)
    n_data = 1 if mesh is None else mesh.data
    batch_size = -(-batch_size // n_data) * n_data
    out: List[EmbeddingSample] = []
    samples = sorted(samples, key=lambda s: s.wav.shape[-1])
    for i in range(0, len(samples), batch_size):
        chunk = samples[i : i + batch_size]
        batch = collate_pad_right(
            [s.wav for s in chunk], pad_to_multiple=pad_to_multiple, dtype=np.float32
        )
        padded = pad_batch_rows({"features": batch.values, "mask": batch.mask}, batch_size)

        def embed(b):
            wav, mask = torch.from_numpy(b["features"]).to(dev), torch.from_numpy(b["mask"]).to(dev)
            if num_ensembles is not None:
                return tuple(e.float() for e in model.compute_ensemble_embeddings(wav, mask, num_ensembles))
            return model.compute_embedding(wav, mask).float()

        got = shard_map_rows(embed, padded, mesh)
        if num_ensembles is not None:
            layers = [e.cpu().numpy() for e in got]
            out.extend(EmbeddingSample(s.key, [lay[j] for lay in layers]) for j, s in enumerate(chunk))
        else:
            embs = got.cpu().numpy()
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
    too), ``network.int8_matmuls=auto`` on a network outside the wav2vec2
    family (as :104-110), a value of it other than true, false or auto,
    and what ``build_model_and_task`` refuses (a loss the network does not
    take, x-vector or wav2spk under AAM), built on the meta device."""
    name = cfg["network"].get("name")
    if name in ("wav2vec2_fc_letter", "wav2vec2_paired"):
        raise ValueError("predict supports speaker (or multitask) models")
    int8 = _canon_int8(cfg["network"].get("int8_matmuls", False))
    if int8 not in (True, False, "auto"):
        raise ValueError(f"network.int8_matmuls must be true/false/auto, got {int8!r}")
    with torch.device("meta"):
        task, _ = build_model_and_task(cfg, cfg["network"].get("explicit_num_speakers") or 2)
    if int8 == "auto" and not hasattr(getattr(task.model, "cfg", None), "w2v2"):
        raise ValueError("network.int8_matmuls=auto is only supported for wav2vec2-family networks")


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


def run_predictions(cfg: Dict, device: DeviceLike = None) -> Optional[pathlib.Path]:
    """Score ``cfg["pair_prediction_path"]`` over the audio under
    ``cfg["predict_folder_path"]``; returns the score file's path (None on
    the ranks other than 0 of a caller's group). Runs on the card unless
    ``device="cpu"``; raises without a card, or with more ranks on the card
    than cards, before it reads anything. ``trainer.num_devices`` N > 1
    shards the extraction over N ranks (module docstring): in the process
    group that exists, else in N ranks spawned here, whose rank 0's path
    this returns."""
    requested = torch.device("cuda" if device is None else device)
    n = resolve_num_devices(cfg["trainer"].get("num_devices", "all"), requested)
    if not dist.is_initialized():  # a caller's group is taken as given (gloo ranks may share a card)
        check_cards(n, requested)
    if needs_spawn(n):
        return spawn(run_predictions, (cfg, device), nprocs=n, device=requested.type,
                     threads=max(torch.get_num_threads() // n, 1))
    mesh = create_mesh(n, device=resolve_device(device))
    with contextlib.nullcontext() if mesh.is_main else contextlib.redirect_stdout(io.StringIO()):
        return _predict(cfg, mesh)


def _predict(cfg: Dict, mesh: Mesh) -> Optional[pathlib.Path]:
    dev, main = mesh.device, mesh.is_main
    folder = pathlib.Path(cfg["predict_folder_path"])
    pair_file = pathlib.Path(cfg["pair_prediction_path"])
    emb_dir = folder / "embeddings"
    pairs: List[Tuple[str, str]] = []
    cached: Dict[str, np.ndarray] = {}
    evaluator = build_evaluator(cfg)
    _check_servable(cfg)

    def audio():  # rank 0: the pairs, the cached embeddings, then each uncached file's samples
        pairs.extend(read_pair_file(pair_file))
        id_list = sorted({p for pair in pairs for p in pair})
        print(f"{len(pairs)} pairs over {len(id_list)} files")
        emb_dir.mkdir(exist_ok=True, parents=True)
        for name in id_list:
            cache = emb_dir / (name + ".npy")
            if cache.exists():
                cached[name] = np.load(cache)
                continue
            yield SpeakerSample(key=name, wav=normalize_waveform(load_raw_audio(folder / name)), ground_truth=-1)

    todo = list(shared_iter(audio() if main else None, mesh))
    if todo:
        print(f"computing {len(todo)} speaker embeddings")
        auto = _canon_int8(cfg["network"].get("int8_matmuls", False)) == "auto"
        if auto:  # one model with int8 sites, switched per bucket batch
            cfg = copy.deepcopy(cfg)
            cfg["network"]["int8_matmuls"] = True
        model = build_predict_model(cfg, dev)
        embed = dispatch_embed(model, cfg) if auto else model
        dl = cfg["data"]["dataloader"]
        fresh = extract_embeddings(
            embed, todo,
            pad_to_multiple=dl.get("test_pad_to_multiple", 16000),
            batch_size=dl.get("test_batch_size", 8),
            device=dev,
            mesh=mesh,
        )
        if auto:
            n8 = sum(1 for _, used in embed.calls if used)
            print(f"int8 auto dispatch: {n8}/{len(embed.calls)} bucket batches on int8 "
                  f"(threshold {embed.min_samples} samples)")
        if not main:
            return None
        for s in fresh:
            out = emb_dir / (s.sample_id + ".npy")
            out.parent.mkdir(exist_ok=True, parents=True)
            np.save(out, s.embedding)
            cached[s.sample_id] = np.asarray(s.embedding)
    if not main:
        return None

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
