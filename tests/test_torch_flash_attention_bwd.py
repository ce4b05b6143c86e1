"""The port's attention backward (``FlashAttentionFunction`` on CPU tensors,
which runs the plain versions of the dq and dk/dv kernels) against
``jax.vjp`` of the JAX package's Pallas kernels in interpret mode, at dropout
rates 0 and 0.1, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.ops.flash_attention import flash_attention_kernel
from w2v2_speaker_tpu_torch.ops import flash_attention as port

# the JAX backward tests' f32 tolerances (tests/test_flash_attention.py:129)
RTOL, ATOL = 5e-4, 5e-5
SEED = 20240611


def _inputs(b, t, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize(
    "t, lengths",
    [(256, None), (300, [300, 137, 61]), (200, [200, 0])],
    ids=["no_mask", "ragged", "zero_length_row"],
)
def test_backward_matches_jax_vjp(t, lengths, rate):
    b = 1 if lengths is None else len(lengths)
    q, k, v, g = _inputs(b, t, seed=t)
    lens = np.full(b, t) if lengths is None else np.asarray(lengths)
    valid = np.arange(t)[None, :] < lens[:, None]
    key_mask = None if lengths is None else jnp.asarray(valid)
    kw = dict(block_q=128, block_k=128, interpret=True, dropout_rate=rate,
              dropout_seed=jnp.asarray([SEED], jnp.int32) if rate else None)
    _, vjp = jax.vjp(lambda *a: flash_attention_kernel(*a, key_mask, **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    before = (port.flash_attention_bwd_dq.launches, port.flash_attention_bwd_dkv.launches)
    o = port.flash_attention(tq, tk, tv, tl, dropout_rate=rate, seed=SEED if rate else None)
    got = [x.numpy() for x in torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))]
    assert (port.flash_attention_bwd_dq.launches, port.flash_attention_bwd_dkv.launches) == before
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL, err_msg=name)
    for x in got:  # rows past the length (queries for dq, keys for dk, dv)
        assert np.all(x[~valid] == 0.0)


def test_kernel_wrappers_on_cpu_give_the_plain_backward():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 70, seed=5))
    lens = torch.tensor([70, 33], dtype=torch.int32)
    o, lse = port.flash_attention_fwd(q, k, v, lens, 0.1, 7, return_lse=True)
    delta = port.attention_delta(o, do)
    assert delta.shape == (2, 2, 70) and delta.is_contiguous()
    args = (q, k, v, do, lse, delta, lens, 0.1, 7)
    dq, dk, dv = port.flash_attention_bwd_plain(*args)
    torch.testing.assert_close(port.flash_attention_bwd_dq(*args), dq, rtol=0, atol=0)
    for a, w in zip(port.flash_attention_bwd_dkv(*args), (dk, dv)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    for a, w in zip(port.flash_attention_bwd(q, k, v, o, do, lse, lens, 0.1, 7), (dq, dk, dv)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_grad_or_dropout_route_through_the_function():
    q = torch.randn(1, 8, 1, 64)
    assert port.flash_attention(q, q, q).grad_fn is None  # inference path
    dropped = port.flash_attention(q, q, q, dropout_rate=0.1, seed=1)
    torch.testing.assert_close(dropped, port.flash_attention_fwd(q, q, q, None, 0.1, 1)[0], rtol=0, atol=0)
    qg = q.clone().requires_grad_()
    assert type(port.flash_attention(qg, q, q).grad_fn).__name__ == "FlashAttentionFunctionBackward"
    with torch.no_grad():
        assert port.flash_attention(qg, q, q).grad_fn is None


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_float64_evaluation_matches_jax_vjp_and_bounds_the_plain_backward(rate):
    """``attention_bwd_float64`` (the yardstick of the float32 kernels'
    accuracy) against ``jax.vjp`` of the JAX package's Pallas kernels in
    interpret mode at the JAX tests' float32 limits, rows past the length
    exactly 0; the plain float32 backward lies within 1e-5 of it (norm of
    the error over the norm), and an output rounded to tf32 (~3 decimal
    digits) far outside that."""
    t, lengths = 100, [100, 64, 1]
    b = len(lengths)
    q, k, v, g = _inputs(b, t, seed=3)
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    kw = dict(block_q=128, block_k=128, interpret=True, dropout_rate=rate,
              dropout_seed=jnp.asarray([SEED], jnp.int32) if rate else None)
    _, vjp = jax.vjp(lambda *a: flash_attention_kernel(*a, jnp.asarray(valid), **kw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    lens = torch.tensor(lengths, dtype=torch.int32)
    seed = SEED if rate else None
    o, lse = port.flash_attention_fwd(tq, tk, tv, lens, rate, seed, return_lse=True)
    args = (tq, tk, tv, tg, lse, port.attention_delta(o, tg), lens, rate, seed)
    exact = port.attention_bwd_float64(*args)
    for name, e, w, plain in zip(("dq", "dk", "dv"), exact, want, port.flash_attention_bwd_plain(*args)):
        assert e.dtype == torch.float64
        np.testing.assert_allclose(e.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
        assert np.all(e.numpy()[~valid] == 0.0)
        assert port.norm_distance(plain, e) < 1e-5, name
        tf32 = (plain.view(torch.int32) & ~0x1FFF).view(torch.float32)  # 10 mantissa bits kept
        assert port.norm_distance(tf32, e) > 100 * port.norm_distance(plain, e), name
