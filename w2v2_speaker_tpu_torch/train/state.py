"""Train state and the optimizer transforms of the speaker recipe.

Counterpart of ``w2v2_speaker_tpu/train/state.py``: ``TrainState`` (:22)
and ``make_freeze_schedule_tx`` (:60), with the optax pieces that
``runtime/experiment.py::build_optimizer`` (:616) chains:
``optax.adam`` / ``optax.adamw`` (with ``mu_dtype``) as ``AdamTx``,
``optax.sgd`` after ``optax.add_decayed_weights`` as ``SgdTx`` and
``optax.clip_by_global_norm`` as ``ClipTx``. A transform's learning rate
is its schedule's value at the transform's step count; the
``reduce_on_plateau`` schedule (``objectives/schedules.py::PlateauSchedule``)
holds the rate that the train loop sets after each validation, as
``optax.inject_hyperparams`` holds it in the optimizer state, and a
transform's ``state_dict`` carries it. ``find_schedule`` reaches it through
the clip and freeze wrappers.

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

import numpy as np
import torch
from torch import nn

__all__ = ["AdamTx", "ClipTx", "SgdTx", "TrainState", "find_schedule", "make_freeze_schedule_tx"]

NamedParams = List[Tuple[str, torch.Tensor]]


def _schedule_state(schedule) -> Optional[dict]:
    return schedule.state_dict() if hasattr(schedule, "state_dict") else None


def _load_schedule_state(schedule, state: Optional[dict]) -> None:
    if state is not None:
        schedule.load_state_dict(state)


class AdamTx:
    """``optax.adam(schedule, b1, b2, eps, mu_dtype)``, or ``optax.adamw``
    with ``weight_decay`` (decoupled: lr x (m_hat / (sqrt(v_hat) + eps) +
    weight_decay x param)), with the learning rate of step ``count`` (0 at
    the first update) taken from ``schedule``. Every parameter must have a
    gradient at every update (zeros where it had none), so the
    per-parameter step count stays optax's shared count.

    Without ``mu_dtype`` the update is ``torch.optim.Adam`` (``AdamW``
    with a weight decay). With it (``torch.bfloat16``) the first moment is
    stored in that dtype beside float32 parameters, which torch's
    optimizers cannot do, and the update follows optax's
    ``scale_by_adam`` step for step: mu = (1 - b1) g + b1 x mu_stored,
    where the product with the stored moment is rounded in its dtype with
    b1 itself rounded to that dtype (optax's Python scalar takes the
    array's dtype) and the sum is float32; that float32 mu feeds this
    step's bias-corrected update, and only then is it rounded for
    storage."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: Optional[torch.dtype] = None):
        self.schedule, self.betas, self.eps = schedule, (b1, b2), eps
        self.weight_decay, self.mu_dtype = float(weight_decay or 0.0), mu_dtype
        self.count = 0
        self.adam: Optional[torch.optim.Optimizer] = None
        self.params: List[torch.Tensor] = []
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, named_params: NamedParams) -> None:
        self.params = [p for _, p in named_params]
        self.count = 0
        if self.mu_dtype is None:
            opt = torch.optim.AdamW if self.weight_decay else torch.optim.Adam
            self.adam = opt(self.params, lr=self.schedule(0), betas=self.betas, eps=self.eps,
                            weight_decay=self.weight_decay)
            return
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=self.mu_dtype) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, named_params: NamedParams) -> None:
        lr = self.schedule(self.count)
        if self.adam is not None:
            for group in self.adam.param_groups:
                group["lr"] = lr
            self.adam.step()
        else:
            self._low_precision_mu_step(lr)
        self.count += 1

    def _low_precision_mu_step(self, lr: float) -> None:
        b1, b2 = self.betas
        n = self.count + 1
        grads = [p.grad for p in self.params]
        b1_low = float(torch.tensor(b1, dtype=self.mu_dtype))
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(self.mu, b1_low)])
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        del sq
        # optax's bias corrections, 1 - b ** count in float32
        mu_hat = torch._foreach_div(mu, float(np.float32(1) - np.float32(b1) ** np.float32(n)))
        denom = torch._foreach_div(self.nu, float(np.float32(1) - np.float32(b2) ** np.float32(n)))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(mu_hat, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, mu_hat, alpha=-lr)
        del mu_hat
        torch._foreach_copy_(self.mu, mu)

    def state_dict(self) -> dict:
        out = {"count": self.count, "schedule": _schedule_state(self.schedule)}
        if self.adam is not None:
            return {**out, "adam": self.adam.state_dict()}
        return {**out, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        _load_schedule_state(self.schedule, state.get("schedule"))
        if self.adam is not None:
            self.adam.load_state_dict(state["adam"])
            return
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"]), strict=True):
            dst.copy_(src)


class SgdTx:
    """``optax.sgd(schedule, momentum)``, after
    ``optax.add_decayed_weights(weight_decay)`` when that is set (torch
    SGD's semantics: the decay is added to the gradient before the
    momentum), on ``torch.optim.SGD``: buf = momentum x buf + g (buf = g at
    the first update, as optax's zero-initialised trace gives), param -=
    lr x buf."""

    def __init__(self, schedule: Callable[[int], float], momentum: Optional[float] = None,
                 weight_decay: float = 0.0):
        self.schedule, self.momentum = schedule, float(momentum or 0.0)
        self.weight_decay = float(weight_decay or 0.0)
        self.count = 0
        self.sgd: Optional[torch.optim.SGD] = None

    def init(self, named_params: NamedParams) -> None:
        self.sgd = torch.optim.SGD([p for _, p in named_params], lr=self.schedule(0), momentum=self.momentum,
                                   weight_decay=self.weight_decay)
        self.count = 0

    def update(self, named_params: NamedParams) -> None:
        for group in self.sgd.param_groups:
            group["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "schedule": _schedule_state(self.schedule), "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        _load_schedule_state(self.schedule, state.get("schedule"))
        self.sgd.load_state_dict(state["sgd"])


def find_schedule(tx):
    """The schedule of the optimizer inside ``tx`` (through ``ClipTx`` and
    the freeze wrappers)."""
    while not hasattr(tx, "schedule"):
        tx = tx.inner
    return tx.schedule


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
