"""The port's attention (its plain PyTorch version, which a CPU tensor runs)
against the JAX package's Pallas forward kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.ops.flash_attention import flash_attention_kernel
from w2v2_speaker_tpu_torch.ops import flash_attention as port

# the JAX kernel tests' f32 tolerances (tests/test_flash_attention.py)
RTOL, ATOL = 2e-4, 2e-5


def _qkv(b, t, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "t, lengths",
    [
        (256, None),  # no mask
        (300, [300, 137, 61]),  # ragged suffix mask
        (200, [200, 0]),  # a zero-length row
        (77, [77, 40]),  # T not a multiple of 128
    ],
    ids=["no_mask", "ragged", "zero_length_row", "t_not_multiple_of_128"],
)
def test_plain_matches_jax_kernel(t, lengths):
    b = 1 if lengths is None else len(lengths)
    q, k, v = _qkv(b, t, seed=t)
    lens = np.full(b, t) if lengths is None else np.asarray(lengths)
    valid = np.arange(t)[None, :] < lens[:, None]
    want = np.asarray(
        flash_attention_kernel(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if lengths is None else jnp.asarray(valid),
            block_q=128, block_k=128, interpret=True,
        )
    )
    before = port.flash_attention.launches
    got = port.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if lengths is None else torch.tensor(lengths, dtype=torch.int32),
    ).numpy()
    assert port.flash_attention.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=ATOL)
    assert np.all(got[~valid] == 0.0)  # padded query rows are exactly 0


def test_plain_bf16_matches_jax_kernel():
    q, k, v = _qkv(2, 128, seed=3)
    lens = np.array([128, 90])
    valid = np.arange(128)[None, :] < lens[:, None]
    want = flash_attention_kernel(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(valid),
        block_q=128, block_k=128, interpret=True,
    )
    got = port.flash_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(lens),
    )
    assert got.dtype == torch.bfloat16
    # the JAX kernel tests' bf16 tolerance (tests/test_flash_attention.py)
    np.testing.assert_allclose(
        got.float().numpy()[valid], np.asarray(want, np.float32)[valid],
        rtol=2e-2, atol=2e-2,
    )


def test_plain_matches_reference_attention_on_valid_rows():
    """Same function as the port's reference attention where a row is
    valid; lengths past T clamp to T and negative lengths to 0."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 50, seed=9))
    lengths = torch.tensor([80, 23, -4])
    mask = torch.arange(50)[None, :] < lengths.clamp(0, 50)[:, None]
    got = port.flash_attention(q, k, v, lengths)
    want = port.reference_attention(q, k, v, mask)
    torch.testing.assert_close(got[mask], want[mask], rtol=RTOL, atol=ATOL)
    assert torch.all(got[~mask] == 0)


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    q = torch.zeros(1, 4, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.flash_attention(q, q, q)


def test_kernel_tolerance_scales_bf16_to_the_outputs():
    assert port.kernel_tolerance(torch.ones(3, dtype=torch.float32)) == (2e-4, 2e-5)
    small = torch.full((4, 64), 0.03, dtype=torch.bfloat16)
    rtol, atol = port.kernel_tolerance(small)
    assert rtol == 2e-2
    assert atol == pytest.approx(2.0**-5 * 0.03, rel=1e-2)  # bf16 rounds 0.03
    assert port.kernel_tolerance(small * 10)[1] == pytest.approx(10 * atol, rel=1e-2)
