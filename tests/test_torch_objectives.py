"""The port's CE loss, AAM margin and head, and one-cycle schedule against
the JAX package's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.models import heads as jheads
from w2v2_speaker_tpu.objectives import losses as jlosses
from w2v2_speaker_tpu.objectives import schedules as jschedules
from w2v2_speaker_tpu_torch.models import heads as theads
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


@pytest.mark.parametrize("easy_margin", [False, True], ids=["margin", "easy_margin"])
def test_aam_margin_logits_match_jax(easy_margin):
    """Target cosines at +-1, near them, at the threshold cos(pi - m) and
    either side of it, at 0 and in between; the other classes random.
    f32 rounding times the scale of 30: rtol 1e-6, atol 1e-5."""
    m, scale = 0.2, 30.0
    th = math.cos(math.pi - m)
    targets = [1.0, -1.0, 1 - 1e-7, -1 + 1e-7, th, th + 1e-6, th - 1e-6, 0.0, 0.37, -0.52, 1e-7]
    rng = np.random.default_rng(3)
    cosine = rng.uniform(-1, 1, (len(targets), 7)).astype(np.float32)
    labels = np.arange(len(targets)) % 7
    cosine[np.arange(len(targets)), labels] = targets
    want = jlosses.aam_margin_logits(jnp.asarray(cosine), jnp.asarray(labels), m, scale, easy_margin)
    got = tlosses.aam_margin_logits(torch.from_numpy(cosine), torch.from_numpy(labels), m, scale,
                                    easy_margin)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_aam_head_matches_jax():
    """Loss and predictions with labels, scaled cosines without; a zero
    embedding row exercises the 1e-12 clamp of the normalisation."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(5, 16)).astype(np.float32)
    emb[2] = 0.0
    labels = rng.integers(0, 9, 5)
    head = jheads.AAMSoftmaxHead(num_classes=9)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(emb), jnp.asarray(labels))
    port = theads.AAMSoftmaxHead(16, 9)
    port.weights.data = torch.from_numpy(np.array(params["params"]["weights"]))
    for lab in (labels, None):
        want = head.apply(params, jnp.asarray(emb), None if lab is None else jnp.asarray(lab))
        got = port(torch.from_numpy(emb), None if lab is None else torch.from_numpy(lab))
        if lab is None:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-6)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-7)


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
