"""The port's CE loss and one-cycle schedule against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.objectives import losses as jlosses
from w2v2_speaker_tpu.objectives import schedules as jschedules
from w2v2_speaker_tpu_torch.objectives import losses as tlosses
from w2v2_speaker_tpu_torch.objectives import schedules as tschedules


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weighted"])
def test_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, 6)
    weights = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    want_loss, want_preds = jlosses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), None if weights is None else jnp.asarray(weights)
    )
    tl = torch.from_numpy(logits).requires_grad_()
    loss, preds = tlosses.cross_entropy(
        tl, torch.from_numpy(labels), None if weights is None else torch.from_numpy(weights)
    )
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_preds), rtol=1e-6, atol=1e-7)
    assert not preds.requires_grad and loss.requires_grad
    if weighted:  # all-zero weights: the sum of weights is clamped to 1
        zero, _ = tlosses.cross_entropy(tl, torch.from_numpy(labels), torch.zeros(6))
        assert zero.item() == 0.0


@pytest.mark.parametrize("max_lr, total", [(9e-5, 100), (1e-3, 37)])
def test_one_cycle_matches_jax_at_every_step(max_lr, total):
    """rtol 1e-6, and an atol of 1e-7 of the peak: optax evaluates the
    cosine in float32, whose last-bit error times the half-amplitude of a
    phase is ~3e-8 of the peak, which near a phase's end is more than 1e-6
    of the (small) rate itself."""
    want = jschedules.one_cycle(max_lr, total)
    got = tschedules.one_cycle(max_lr, total)
    steps = range(total + 3)
    np.testing.assert_allclose(
        [got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-6, atol=1e-7 * max_lr
    )
    assert got(int(0.3 * total)) == max_lr
    assert got(total + 10) == pytest.approx(max_lr / 25 / 1e4)


def test_one_cycle_phase_ends_are_optax_not_torch_onecycle():
    """torch's OneCycleLR reaches the peak one step earlier."""
    total, max_lr = 100, 1e-3
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=max_lr)
    sched = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=max_lr, total_steps=total)
    torch_lrs = []
    for _ in range(total):
        torch_lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    port = tschedules.one_cycle(max_lr, total)
    assert int(np.argmax(torch_lrs)) == 29 and port(29) < max_lr and port(30) == max_lr
