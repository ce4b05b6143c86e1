"""The port's CTC forward-backward (``ops/ctc.py``), whose plain versions run
on the CPU, against the JAX package's ``ctc_loss`` (optax) and against
``F.ctc_loss``, float32, on numpy-seeded inputs. The plain versions run
in log space in float64, in the kernels' split: ``ctc_alpha_reference`` +
``ctc_beta_reference`` (the forward), ``ctc_grad_reference`` (the
backward, from alpha and beta).

Limits: the mean loss of ``objectives.losses.ctc_loss`` and its logit
gradient rtol 1e-5 / atol 1e-6 on feasible rows, the limits of
``tests/test_torch_speech.py`` (float32 log-space recursions of three
implementations, each ~1e-6 of a float64 one here). Per row (no division by
the label length) the loss is held at rtol 1e-5 and the gradient at atol
1e-5: one row's gradient entries lie in [-1, 1], and a row's log-likelihood
of ~100 nats carries ~1e-5 of float32 rounding into exp(alpha + beta -
logp) in any implementation. The plain recursions run in float64 from
float64 log-probabilities too and are held at 1e-10 of ``F.ctc_loss``'s
float64 autograd. Cases: label repeats (a blank between), an empty-label
padding row, ragged frames and labels, the minimal feasible T and one frame
less, V = 5995 with L = 1 (the speaker CTC), another blank id. The one
deliberate divergence: a row that cannot fit its label scores 0 with a
gradient of exactly 0 (``zero_infinity``), where optax scores ~1e5 / L.
A call with a gradient (training) and one without (eval, under
``torch.no_grad``) give each row's loss bit for bit. On the CPU the wrappers run the plain versions, launch nothing (their
counters stay) and never call ``F.ctc_loss``; the card's kernels are held
against these plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 39.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.objectives import losses as jlosses
from w2v2_speaker_tpu_torch.objectives import losses as tlosses
from w2v2_speaker_tpu_torch.ops import ctc
from w2v2_speaker_tpu_torch.runtime import experiment as texp

MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6
ROW_RTOL, ROW_GRAD_ATOL = 1e-5, 1e-5
F64_DIFF_ATOL = 1e-10  # the plain recursions in float64 against F.ctc_loss's float64 autograd


def _inputs(seed, logit_lengths, label_lengths, t=40, v=12, s=16, repeats=0):
    """Logits [B, T, V] of N(0, 2), labels of tokens 1..V-1 (``repeats``
    rows start with a doubled token), 0-padded."""
    rng = np.random.default_rng(seed)
    b = len(logit_lengths)
    logits = rng.normal(0, 2, (b, t, v)).astype(np.float32)
    labels = np.zeros((b, s), np.int32)
    for i, n in enumerate(label_lengths):
        labels[i, :n] = rng.integers(1, v, n)
        if i < repeats and n >= 2:
            labels[i, 1] = labels[i, 0]
    return logits, np.asarray(logit_lengths, np.int32), labels, np.asarray(label_lengths, np.int32)


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _port_rows(args, weights, blank=0):
    """Each row's loss and the gradient of sum(weights x rows) of the port."""
    logits, lens, labels, label_lens = _torch(args)
    x = logits.requires_grad_()
    rows = ctc.ctc_loss_rows(x, lens, labels, label_lens, blank)
    (rows * torch.as_tensor(weights, dtype=rows.dtype)).sum().backward()
    return rows.detach().double().numpy(), x.grad.double().numpy()


def _plain_rows64(args, weights):
    """The plain versions' rows and gradient in float64 (the kernels take
    float32 only; the plain recursions take any float type)."""
    logits, lens, labels, label_lens = _torch(args)
    lp = torch.log_softmax(logits.double(), -1)
    alpha, logp = ctc.ctc_alpha_reference(lp, lens, labels, label_lens)
    beta = ctc.ctc_beta_reference(lp, lens, labels, label_lens)
    grad = ctc.ctc_grad_reference(lp, alpha, beta, logp, torch.as_tensor(weights, dtype=torch.float64), lens,
                                  labels, label_lens)
    return torch.where(torch.isfinite(logp), -logp, 0.0).numpy(), grad.numpy()


def _torch_rows(args, weights, blank=0, dtype=torch.float32):
    """The same of ``F.ctc_loss(reduction="none", zero_infinity=True)``."""
    logits, lens, labels, label_lens = _torch(args)
    x = logits.to(dtype).requires_grad_()
    rows = F.ctc_loss(F.log_softmax(x, -1).transpose(0, 1), labels.long(), lens.long(), label_lens.long(),
                      blank=blank, reduction="none", zero_infinity=True)
    (rows * torch.as_tensor(weights, dtype=rows.dtype)).sum().backward()
    return rows.detach().double().numpy(), x.grad.double().numpy()


CASES = {  # (logit lengths, label lengths, T, V, S, rows with a doubled first token)
    "ragged": ((40, 33, 20, 12), (9, 5, 7, 0), 40, 12, 16, 2),
    "repeats": ((30, 30, 17), (12, 8, 6), 30, 5, 12, 3),
    "wide_labels": ((80, 71), (30, 25), 80, 8, 32, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_and_gradient_match_jax_and_torch(case, seed):
    """``objectives.losses.ctc_loss`` (rows / label length, the mean over
    non-empty labels) and its logit gradient against optax's and against
    ``F.ctc_loss``'s same reduction."""
    tl, ll, t, v, s, rep = CASES[case]
    args = _inputs(seed, tl, ll, t, v, s, rep)
    want, want_grad = jax.value_and_grad(jlosses.ctc_loss)(jnp.asarray(args[0]), *args[1:])
    x = torch.from_numpy(args[0]).requires_grad_()
    got = tlosses.ctc_loss(x, *_torch(args[1:]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=MEAN_RTOL, atol=MEAN_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=MEAN_RTOL, atol=MEAN_ATOL)
    valid = (args[3] > 0).astype(np.float64)
    weights = valid / np.maximum(args[3], 1) / valid.sum()
    lib_rows, lib_grad = _torch_rows(args, weights)
    np.testing.assert_allclose(got.item(), (lib_rows * weights).sum(), rtol=MEAN_RTOL, atol=MEAN_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), lib_grad, rtol=MEAN_RTOL, atol=MEAN_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_rows_and_hand_written_backward(case):
    """Each row's loss and the gradient of a random weighting of the rows
    against ``F.ctc_loss`` in float32 (and the float32 gradient against
    the float64 one), and the plain recursions in float64 against
    ``F.ctc_loss``'s float64 autograd; two calls bit-equal."""
    tl, ll, t, v, s, rep = CASES[case]
    args = _inputs(7, tl, ll, t, v, s, rep)
    weights = np.random.default_rng(3).uniform(0.2, 1.0, len(tl))
    rows, grad = _port_rows(args, weights)
    lib_rows, lib_grad = _torch_rows(args, weights)
    np.testing.assert_allclose(rows, lib_rows, rtol=ROW_RTOL)
    np.testing.assert_allclose(grad, lib_grad, rtol=0, atol=ROW_GRAD_ATOL)
    rows64, grad64 = _plain_rows64(args, weights)
    lib64, lib_grad64 = _torch_rows(args, weights, dtype=torch.float64)
    np.testing.assert_allclose(rows64, lib64, rtol=1e-12)
    np.testing.assert_allclose(grad64, lib_grad64, rtol=0, atol=F64_DIFF_ATOL)
    np.testing.assert_allclose(grad, lib_grad64, rtol=0, atol=ROW_GRAD_ATOL)
    again = _port_rows(args, weights)
    assert np.array_equal(again[0], rows) and np.array_equal(again[1], grad)


def test_minimal_feasible_frames_and_one_less():
    """A label with a repeat (``a a b``) needs 4 frames (a, blank, a, b):
    at 4 the loss matches ``F.ctc_loss`` and the path is the only one; at 3
    no path fits: loss 0 and a gradient of exactly 0 in the port and in
    ``F.ctc_loss``, while frames past T_b get exactly 0 in every row."""
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 1, (3, 6, 4)).astype(np.float32)
    labels = np.array([[1, 1, 2], [1, 1, 2], [3, 2, 1]], np.int32)
    args = (logits, np.array([4, 3, 3], np.int32), labels, np.array([3, 3, 3], np.int32))
    rows, grad = _port_rows(args, np.ones(3))
    lib_rows, lib_grad = _torch_rows(args, np.ones(3))
    np.testing.assert_allclose(rows, lib_rows, rtol=ROW_RTOL)
    lp = torch.log_softmax(torch.from_numpy(logits[0, :4]).double(), -1).numpy()
    only_path = -(lp[0, 1] + lp[1, 0] + lp[2, 1] + lp[3, 2])
    np.testing.assert_allclose(rows[0], only_path, rtol=ROW_RTOL)
    assert rows[1] == 0.0 and np.all(grad[1] == 0.0) and np.all(lib_grad[1] == 0.0)
    assert rows[2] > 0 and np.all(grad[0, 4:] == 0.0) and np.all(grad[2, 3:] == 0.0)
    np.testing.assert_allclose(grad, lib_grad, rtol=0, atol=ROW_GRAD_ATOL)


def test_speaker_ctc_shape_matches_jax_and_torch():
    """The speaker CTC's form at small size: V = 5995 (5994 speakers and
    the blank, whose bias the head sets to 100, here as a logit offset),
    one token a row, every row's frames whole."""
    rng = np.random.default_rng(17)
    b, t, v = 3, 12, 5995
    logits = rng.normal(0, 1, (b, t, v)).astype(np.float32)
    logits[:, :, 0] += 5.0
    labels = rng.integers(1, v, (b, 1)).astype(np.int32)
    args = (logits, np.full(b, t, np.int32), labels, np.ones(b, np.int32))
    want, want_grad = jax.value_and_grad(jlosses.ctc_loss)(jnp.asarray(logits), *args[1:])
    x = torch.from_numpy(logits).requires_grad_()
    got = tlosses.ctc_loss(x, *_torch(args[1:]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=MEAN_RTOL, atol=MEAN_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=MEAN_RTOL, atol=MEAN_ATOL)
    rows, grad = _port_rows(args, np.ones(b))
    lib_rows, lib_grad = _torch_rows(args, np.ones(b))
    np.testing.assert_allclose(rows, lib_rows, rtol=ROW_RTOL)
    np.testing.assert_allclose(grad, lib_grad, rtol=0, atol=ROW_GRAD_ATOL)


def test_another_blank_id_matches_torch():
    """``blank`` is an argument of the kernels and their plain versions:
    blank 3 against ``F.ctc_loss(blank=3)`` (tokens drawn from the others)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (2, 20, 6)).astype(np.float32)
    labels = rng.choice([0, 1, 2, 4, 5], (2, 6)).astype(np.int32)
    args = (logits, np.array([20, 15], np.int32), labels, np.array([6, 4], np.int32))
    rows, grad = _port_rows(args, np.array([1.0, 0.5]), blank=3)
    lib_rows, lib_grad = _torch_rows(args, np.array([1.0, 0.5]), blank=3)
    np.testing.assert_allclose(rows, lib_rows, rtol=ROW_RTOL)
    np.testing.assert_allclose(grad, lib_grad, rtol=0, atol=ROW_GRAD_ATOL)


def test_infeasible_row_diverges_from_jax_as_documented():
    """Row 1 has 3 frames for a label of 5: the port scores it 0 with no
    gradient (``zero_infinity``); optax scores it ~1e5 / L, which the JAX
    package's ``isfinite`` test lets through. The feasible row agrees, and
    the mean over both rows is the feasible row's over 2."""
    args = _inputs(3, (40, 3), (9, 5))
    per_row = []
    for i in range(2):
        sl = slice(i, i + 1)
        x = torch.from_numpy(args[0][sl]).requires_grad_()
        got = tlosses.ctc_loss(x, *(torch.from_numpy(a[sl]) for a in args[1:]))
        got.backward()
        want = float(jlosses.ctc_loss(jnp.asarray(args[0][sl]), *(a[sl] for a in args[1:])))
        per_row.append((got.item(), want, float(x.grad.abs().max())))
    (feasible, feasible_jax, _), (infeasible, infeasible_jax, infeasible_grad) = per_row
    np.testing.assert_allclose(feasible, feasible_jax, rtol=MEAN_RTOL)
    assert infeasible == 0.0 and infeasible_grad == 0.0
    assert infeasible_jax >= 1e4 / args[3][1]
    both = tlosses.ctc_loss(*_torch(args))
    np.testing.assert_allclose(both.item(), feasible / 2, rtol=MEAN_RTOL)


def test_cpu_route_runs_the_plain_versions_deterministically():
    """On CPU tensors the wrappers are the plain versions (the counters do
    not move), also under ``trainer.deterministic``'s
    ``torch.use_deterministic_algorithms``; log alpha is -inf outside each
    row's states, log beta also past each row's frames, the backward's
    gradient 0 past each row's frames; ``log_space`` reads the kernels'
    (m, k) pairs as log alpha."""
    args = _torch(_inputs(5, (10, 7, 0), (3, 2, 0), t=10, v=5, s=4))
    lp = torch.log_softmax(args[0], -1)
    before = ctc.ctc_alpha_beta.launches, ctc.ctc_grad.launches
    with texp.deterministic_mode(True, torch.device("cpu")):
        alpha, beta, logp = ctc.ctc_alpha_beta(lp, *args[1:])
        grad = ctc.ctc_grad(lp, alpha, beta, logp, torch.ones(3), *args[1:])
    assert (ctc.ctc_alpha_beta.launches, ctc.ctc_grad.launches) == before
    want_alpha, want_logp = ctc.ctc_alpha_reference(lp, *args[1:])
    assert torch.equal(alpha, want_alpha) and torch.equal(logp, want_logp)
    assert torch.equal(beta, ctc.ctc_beta_reference(lp, *args[1:]))
    assert torch.equal(grad, ctc.ctc_grad_reference(lp, alpha, beta, logp, torch.ones(3), *args[1:]))
    assert torch.isinf(alpha[0, :, 7:]).all() and torch.isinf(alpha[1, :, 5:]).all()
    assert torch.isinf(beta[1, 7:]).all() and torch.isinf(beta[0, :, 7:]).all()
    assert logp[2] == 0.0 and torch.all(grad[1, 7:] == 0) and torch.all(grad[2] == 0)
    pairs = torch.tensor([[0.75, -3.0], [0.5, -(1 << 29)], [0.5, 1.0]], dtype=torch.float64)
    want = torch.log(torch.tensor([0.09375, 0.0, 1.0], dtype=torch.float64))
    torch.testing.assert_close(ctc.log_space(pairs), want, rtol=1e-15, atol=1e-15)
    with pytest.raises(ValueError, match="float32 log-probabilities"):
        ctc.ctc_alpha_beta(lp.double(), *args[1:])


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_and_eval_routes_give_the_same_loss(case):
    """A call whose logits need a gradient (training) and one under
    ``torch.no_grad`` (eval) give each row's loss bit for bit, through
    ``ctc_loss_rows`` and through ``objectives.losses.ctc_loss``: both
    run the one forward, ``ctc_alpha_beta``, whose logp is the loss."""
    tl, ll, t, v, s, rep = CASES[case]
    logits, lens, labels, label_lens = _torch(_inputs(11, tl, ll, t, v, s, rep))
    train = ctc.ctc_loss_rows(logits.clone().requires_grad_(), lens, labels, label_lens)
    with torch.no_grad():
        evaluated = ctc.ctc_loss_rows(logits, lens, labels, label_lens)
    assert train.requires_grad and not evaluated.requires_grad
    assert torch.equal(train.detach(), evaluated)
    mean_train = tlosses.ctc_loss(logits.clone().requires_grad_(), lens, labels, label_lens)
    assert torch.equal(mean_train.detach(), tlosses.ctc_loss(logits, lens, labels, label_lens))
    logp = ctc.ctc_alpha_beta(torch.log_softmax(logits, -1), lens, labels, label_lens)[2]
    assert torch.equal(evaluated, torch.where(torch.isfinite(logp), -logp, 0.0).float())


def test_cpu_route_never_calls_the_library_ctc(monkeypatch):
    """On the CPU the loss, its gradient and a forward without a gradient
    run the plain versions only: ``F.ctc_loss`` and ``torch.ctc_loss``,
    replaced by functions that raise, are never reached, and the result is
    the one the library gives when it is restored."""

    def refuse(*args, **kwargs):
        raise AssertionError("the library CTC was called")

    args = _inputs(9, (40, 33, 20, 12), (9, 5, 7, 0))
    weights = np.array([0.5, 1.0, 0.25, 0.75])
    with monkeypatch.context() as patched:
        patched.setattr(F, "ctc_loss", refuse)
        patched.setattr(torch, "ctc_loss", refuse)
        with pytest.raises(AssertionError, match="library CTC"):
            F.ctc_loss(None, None, None, None)
        rows, grad = _port_rows(args, weights)
        with torch.no_grad():
            evaluated = ctc.ctc_loss_rows(*_torch(args))
    lib_rows, lib_grad = _torch_rows(args, weights)
    np.testing.assert_allclose(rows, lib_rows, rtol=ROW_RTOL)
    np.testing.assert_allclose(grad, lib_grad, rtol=0, atol=ROW_GRAD_ATOL)
    assert np.array_equal(evaluated.double().numpy(), rows)
