"""Train step builder.

Counterpart of ``w2v2_speaker_tpu/train/steps.py::make_train_step`` (:30):
forward, backward and optimizer update, eagerly. Gradient accumulation
averages the microbatches' gradients (:91-128); ``return_embeddings`` adds
the detached float32 embeddings to the metrics; ``steps_per_dispatch=K``
takes a stacked batch and runs K steps in a Python loop (the JAX package
scans them inside one device program, :54-61, to amortize dispatches
through its TPU transport; here it only keeps the recipe's batch layout).

With a ``mesh`` of more than one data rank the step takes this rank's rows
(``parallel.mesh.select_rows``: its block of each microbatch, in the JAX
layout), runs each microbatch inside ``shard_rows`` (so dropout, BatchNorm,
the losses and the metrics act on the global microbatch), and sums every
gradient over the data group in one flat all-reduce before the update
(``all_reduce_grads``; clipping then acts on the reduced gradient). That
explicit reduce, rather than ``DistributedDataParallel``, keeps a layer
that layerdrop skipped, or a frozen parameter, a plain zero, and keeps a
world of 1 the function it was.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import torch

from ..parallel.mesh import Mesh, all_gather_rows, all_reduce_grads, shard_rows
from .multitask_task import MultitaskTask
from .paired_task import PairedSpeakerTask
from .speaker_task import SpeakerTask
from .speech_task import SpeechTask
from .state import TrainState

__all__ = ["make_train_step"]


def _stack(per_step: List[Dict]) -> Dict:
    out = {}
    for key in per_step[0]:
        vals = [m[key] for m in per_step]
        out[key] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) else torch.tensor(vals)
    return out


def make_train_step(
    task: Union[SpeakerTask, PairedSpeakerTask, SpeechTask, MultitaskTask],
    accumulate_steps: int = 1,
    return_embeddings: bool = False,
    steps_per_dispatch: int = 1,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned.

    ``batch``: what ``task.loss_fn`` reads, every entry with the rows
    leading: ``features`` [B, N], optional ``mask`` [B, N] and ``labels``
    [B] for a ``SpeakerTask``; ``features_a`` / ``features_b``, optional
    ``mask_a`` / ``mask_b`` and ``labels`` for a ``PairedSpeakerTask``;
    ``features``, ``mask``, ``labels`` [B, S] and ``label_lengths`` for a
    ``SpeechTask``, and also ``speaker_labels`` [B] for a ``MultitaskTask``
    (with ``steps_per_dispatch`` K > 1, every entry stacked [K, B, ...]
    and the metrics stacked [K, ...]). With ``accumulate_steps`` A > 1 the
    batch is split into A microbatches along axis 0 and the gradients are
    averaged. Every random draw comes from ``state.generator``. With a
    ``mesh``, ``batch`` is this rank's rows (``select_rows`` with the same
    ``accumulate_steps``) and the metrics, ``_embedding`` included, are
    the global batch's.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.zero_grad(set_to_none=True)
        micro = [batch] if accumulate_steps == 1 else [
            dict(zip(batch, parts))
            for parts in zip(*(v.chunk(accumulate_steps) for v in batch.values()))
        ]
        per_micro = []
        for mb in micro:
            with shard_rows(mesh, next(iter(mb.values())).shape[0]):
                loss, aux = task.loss_fn(mb, state.generator, train=True)
                loss.backward()
            metrics = dict(aux["metrics"])
            if return_embeddings:
                metrics["_embedding"] = all_gather_rows(aux["out"]["embedding"].detach().float(), mesh)
            per_micro.append(metrics)
        all_reduce_grads(list(state.model.parameters()), mesh)
        if accumulate_steps == 1:
            metrics = per_micro[0]
        else:
            with torch.no_grad():
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accumulate_steps)
            stacked = _stack(per_micro)
            metrics = {k: v.float().mean() for k, v in stacked.items() if k != "_embedding"}
            if return_embeddings:  # [A, B/A, D] -> [B, D]
                metrics["_embedding"] = stacked["_embedding"].flatten(0, 1)
        state.apply_gradients()
        return state, metrics

    if steps_per_dispatch > 1:
        single = step

        def step(state: TrainState, stacked: Dict[str, torch.Tensor]):
            per_step = []
            for i in range(steps_per_dispatch):
                state, metrics = single(state, {k: v[i] for k, v in stacked.items()})
                per_step.append(metrics)
            return state, _stack(per_step)

    return step
