"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
