"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the attention forward (inference path, and with the LSE and dropout) and the
dq and dk/dv backward kernels.

These tests need an NVIDIA card and ``nvcc``; without a card they skip.
The repository's ``tests/conftest.py`` imports JAX, which the card machine
need not have, so run them there without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from w2v2_speaker_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, lengths", [
    (149, [149, 149]), (200, [200, 131, 64, 0]), (65, [1, 65]),
    (100, None),  # no lengths: every key valid
    (80, [95, -4]),  # out of range: the kernel clamps to [0, T]
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, t, lengths):
    gen = torch.Generator(device=cuda).manual_seed(t)
    b = 2 if lengths is None else len(lengths)
    qkv = torch.randn(b, t, 3 * 128, generator=gen, device=cuda).to(dtype)
    q, k, v = (x.view(b, t, 2, 64) for x in qkv.split(128, dim=-1))
    lens = None if lengths is None else torch.tensor(lengths, device=cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, lens)
    n = torch.full((b,), t, device=cuda) if lens is None else lens.clamp(0, t)
    valid = torch.arange(t, device=cuda)[None, :] < n[:, None]
    # f32: the JAX kernel tests' 2e-4 / 2e-5; bf16: scaled to the outputs' RMS
    rtol, atol = fa.kernel_tolerance(want[valid])
    torch.testing.assert_close(got[valid].float(), want[valid].float(), rtol=rtol, atol=atol)
    assert torch.all(got[~valid] == 0)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="D=64"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_attention(y, y, y)


def _inputs(cuda, dtype, t, lengths, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b = 2 if lengths is None else len(lengths)
    qkv = torch.randn(b, t, 3 * 128, generator=gen, device=cuda).to(dtype)
    q, k, v = (x.view(b, t, 2, 64) for x in qkv.split(128, dim=-1))
    do = torch.randn(b, t, 2, 64, generator=gen, device=cuda).to(dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda)
    n = torch.full((b,), t, device=cuda) if lens is None else lens.clamp(0, t)
    valid = torch.arange(t, device=cuda)[None, :] < n[:, None]
    return q, k, v, do, lens, valid


def _close(got, want, valid, backward):
    rtol, atol = fa.kernel_tolerance(want[valid], backward)
    torch.testing.assert_close(got[valid].float(), want[valid].float(), rtol=rtol, atol=atol)
    assert torch.all(got[~valid] == 0)


CASES = [(149, [149, 149]), (200, [200, 131, 64, 0]), (65, [1, 65]), (100, None), (80, [95, -4])]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, lengths", CASES)
def test_forward_with_lse_and_dropout_matches_plain(cuda, dtype, t, lengths, rate):
    q, k, v, _, lens, valid = _inputs(cuda, dtype, t, lengths, t)
    seed = -123456789 if rate else None
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want_o, want_lse = fa.flash_attention_plain(q, k, v, lens, rate, seed, return_lse=True)
    _close(o, want_o, valid, backward=False)
    rows = valid[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[rows], want_lse[rows], rtol=2e-4, atol=2e-5)
    assert torch.all(lse[~rows] == 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, lengths", CASES)
def test_backward_kernels_match_plain(cuda, dtype, t, lengths, rate):
    q, k, v, do, lens, valid = _inputs(cuda, dtype, t, lengths, t + 1)
    seed = 97 if rate else None
    o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=True)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, lens, rate, seed)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for got, want in zip((dq, dk, dv), fa.flash_attention_bwd_plain(*args)):
        _close(got, want, valid, backward=True)


def test_autograd_through_the_kernels(cuda):
    """``flash_attention`` under autograd on the card: the forward and both
    backward kernels, against the plain backward of the same forward."""
    q, k, v, do, lens, valid = _inputs(cuda, torch.bfloat16, 149, [149, 90], 3)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(q, k, v, lens, dropout_rate=0.1, seed=5)
    got = torch.autograd.grad(o, (q, k, v), do)
    _, lse = fa.flash_attention_fwd(q, k, v, lens, 0.1, 5, return_lse=True)
    want = fa.flash_attention_bwd_plain(
        q, k, v, do, lse, fa.attention_delta(o, do), lens, 0.1, 5)
    for g, w in zip(got, want):
        _close(g, w, valid, backward=True)
