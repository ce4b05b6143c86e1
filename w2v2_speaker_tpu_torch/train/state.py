"""Train state and the optimizer transforms of the speaker recipe.

Counterpart of ``w2v2_speaker_tpu/train/state.py``: ``TrainState`` (:22)
and ``make_freeze_schedule_tx`` (:60), with the optax pieces that
``runtime/experiment.py::build_optimizer`` (:616) chains for the Adam +
one-cycle recipe: ``optax.adam(schedule)`` as ``AdamTx`` and
``optax.clip_by_global_norm`` as ``ClipTx``.

A transform here updates parameters in place from their ``.grad``:
``init(named_params)`` once, then ``update(named_params)`` once per step,
where ``named_params`` is a list of ``("wav2vec2/encoder/...", param)`` —
the module path joined with "/", so the JAX package's path predicates
carry over. ``state_dict()`` / ``load_state_dict()`` of a transform and of
``TrainState`` hold everything a resumed run needs (moments, counts, the
step generator's state), as the JAX package's checkpoints hold the optax
state and the rng key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

__all__ = ["AdamTx", "ClipTx", "TrainState", "make_freeze_schedule_tx"]

NamedParams = List[Tuple[str, torch.Tensor]]


class AdamTx:
    """``optax.adam(schedule, b1, b2, eps)`` on ``torch.optim.Adam``: the
    same update, lr * m_hat / (sqrt(v_hat) + eps), with the learning rate
    of step ``count`` (0 at the first update) taken from ``schedule``.
    Every parameter must have a gradient at every update (zeros where it
    had none), so Adam's per-parameter step count stays optax's shared
    count."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.betas, self.eps = schedule, (b1, b2), eps
        self.count = 0
        self.adam: Optional[torch.optim.Adam] = None

    def init(self, named_params: NamedParams) -> None:
        self.adam = torch.optim.Adam(
            [p for _, p in named_params], lr=self.schedule(0), betas=self.betas, eps=self.eps
        )
        self.count = 0

    def update(self, named_params: NamedParams) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        self.adam.load_state_dict(state["adam"])


class ClipTx:
    """``optax.chain(optax.clip_by_global_norm(max_norm), inner)``: the
    gradients are scaled by max_norm / norm where their global norm is at
    least max_norm, then ``inner`` updates."""

    def __init__(self, inner, max_norm: float):
        self.inner, self.max_norm = inner, max_norm

    def init(self, named_params: NamedParams) -> None:
        self.inner.init(named_params)

    @torch.no_grad()
    def update(self, named_params: NamedParams) -> None:
        grads = [p.grad for _, p in named_params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        factor = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        for g in grads:
            g.mul_(factor)
        self.inner.update(named_params)

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


class _FreezeTx:
    def __init__(self, inner, frozen_predicate: Callable[[str], bool],
                 num_frozen_steps: Optional[int]):
        self.inner, self.frozen_predicate = inner, frozen_predicate
        self.num_frozen_steps = num_frozen_steps
        self.count = 0

    def init(self, named_params: NamedParams) -> None:
        self.inner.init(named_params)
        self.count = 0

    @torch.no_grad()
    def update(self, named_params: NamedParams) -> None:
        frozen = []
        if self.num_frozen_steps is None or self.count < self.num_frozen_steps:
            frozen = [p for name, p in named_params if self.frozen_predicate(name)]
        saved = [p.detach().clone() for p in frozen]
        for p in frozen:  # zero, not None: the inner count must advance
            p.grad.zero_()
        self.inner.update(named_params)
        for p, old in zip(frozen, saved):
            p.copy_(old)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        self.inner.load_state_dict(state["inner"])


def make_freeze_schedule_tx(inner, frozen_predicate: Callable[[str], bool],
                            num_frozen_steps: Optional[int]):
    """No updates for parameters whose "/"-joined path matches
    ``frozen_predicate`` while step < ``num_frozen_steps`` (None freezes
    forever, 0 disables). Their gradients are zeroed before ``inner`` (the
    optimizer moments see zeros, as in the JAX package, :90-99) and their
    values are restored after it (:101-103)."""
    if num_frozen_steps == 0:
        return inner
    return _FreezeTx(inner, frozen_predicate, num_frozen_steps)


@dataclass
class TrainState:
    """The model (its parameters), the optimizer transform, the step count
    and the step's ``torch.Generator`` (on the CPU: every random draw of a
    step comes from it, so a step is reproducible on either device from one
    seed)."""

    model: nn.Module
    tx: object
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx, seed: int = 0) -> "TrainState":
        state = cls(model, tx, torch.Generator().manual_seed(seed))
        tx.init(state.named_params())
        return state

    def named_params(self) -> NamedParams:
        return [(name.replace(".", "/"), p) for name, p in self.model.named_parameters()]

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``; a parameter
        that took no part in the step (a dropped layer) gets a zero
        gradient, as the JAX ``where`` gives it."""
        named = self.named_params()
        for _, p in named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.tx.update(named)
        self.step += 1

    def state_dict(self) -> dict:
        """The step, the model's ``state_dict``, the transform's state and
        the step generator's state."""
        return {"step": self.step, "model": self.model.state_dict(), "tx": self.tx.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.tx.load_state_dict(state["tx"])
        self.generator.set_state(state["generator"])
