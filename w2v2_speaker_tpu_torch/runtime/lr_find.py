"""Learning-rate range test (``run_lr_range_test`` / ``tune_model``).

Counterpart of ``w2v2_speaker_tpu/runtime/lr_find.py::lr_range_test``
(:29): sweep the learning rate exponentially from ``min_lr`` to ``max_lr``
over ``num_steps`` training steps of plain Adam at its default betas (not
the config's optimizer), the rate of step ``count`` read from a float32
table, record the smoothed loss at each rate, stop when it is not finite
or exceeds ``diverge_factor`` x its best, and suggest the rate at the
steepest descent of the smoothed loss. A batch whose ``features`` shape
differs from the first one's is skipped without a step, so the table does
not advance, but it uses up one of the ``num_steps`` iterations. With
``output_dir``, ``data.json`` holds ``lr`` (the float64 rates of the steps
taken), ``loss`` and ``suggestion``, and ``plot.png`` the curve where
matplotlib imports. In a data-parallel run (``parallel.mesh.current_mesh``)
every step runs over the world, as the JAX package's runs over its mesh
(:21), and rank 0 alone writes the files.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..parallel.mesh import current_mesh, select_rows
from ..train.state import AdamTx, TrainState
from ..train.steps import make_train_step

__all__ = ["lr_range_test"]


def lr_range_test(
    task,
    train_batches: Iterable[Dict],
    device: torch.device,
    min_lr: float = 1e-8,
    max_lr: float = 1.0,
    num_steps: int = 100,
    smoothing: float = 0.05,
    diverge_factor: float = 4.0,
    output_dir: Optional[pathlib.Path] = None,
) -> Dict:
    """Trains ``task.model`` in place from its current weights (the step
    generator seeded with 0); returns {"lr": [...], "loss": [...],
    "suggestion": float}."""
    lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), num_steps))
    lr_table = lrs.astype(np.float32)
    state = TrainState.create(task.model, AdamTx(lambda count: float(lr_table[min(max(count, 0), num_steps - 1)])),
                              seed=0)
    mesh = current_mesh()
    step = make_train_step(task, mesh=mesh)

    losses = []
    smoothed = None
    best = np.inf
    it = iter(train_batches)
    ref_shape = None
    for _ in range(num_steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(train_batches)
            batch = next(it)
        if ref_shape is None:
            ref_shape = batch["features"].shape
        if batch["features"].shape != ref_shape:
            continue
        state, metrics = step(state, {k: torch.from_numpy(v).to(device) for k, v in select_rows(batch, mesh).items()
                                      if isinstance(v, np.ndarray)})
        loss = float(metrics["loss"])
        smoothed = loss if smoothed is None else smoothing * loss + (1 - smoothing) * smoothed
        losses.append(smoothed)
        best = min(best, smoothed)
        if not np.isfinite(smoothed) or smoothed > diverge_factor * best:
            break

    lr_used = lrs[: len(losses)]
    if len(losses) > 3:  # the rate at the steepest descent of the smoothed loss
        suggestion = float(lr_used[int(np.argmin(np.gradient(np.asarray(losses))))])
    else:
        suggestion = float(min_lr)
    result = {"lr": lr_used.tolist(), "loss": losses, "suggestion": suggestion}
    if output_dir is not None and (mesh is None or mesh.is_main):
        output_dir = pathlib.Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        (output_dir / "data.json").write_text(json.dumps(result, indent=2))
        _write_plot(output_dir / "plot.png", lr_used, losses, suggestion)
    return result


def _write_plot(path, lrs, losses, suggestion) -> None:
    """The smoothed loss against the rate, on a log axis, with the
    suggestion marked; nothing without matplotlib (the JSON is the
    record)."""
    if not len(losses):
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(lrs, losses)
    ax.set_xscale("log")
    ax.axvline(suggestion, color="red", linestyle="--", label=f"suggestion {suggestion:.2e}")
    ax.set_xlabel("learning rate")
    ax.set_ylabel("smoothed loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
