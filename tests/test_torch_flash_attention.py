"""The port's attention forward (its plain PyTorch version, which a CPU
tensor runs) against the JAX package's Pallas forward kernel in interpret
mode: the inference path, and the training path with dropout and the LSE."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.ops.flash_attention import _flash_fwd, flash_attention_kernel
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


CASES = [
    (256, None),  # no mask
    (300, [300, 137, 61]),  # ragged suffix mask
    (200, [200, 0]),  # a zero-length row
]
CASE_IDS = ["no_mask", "ragged", "zero_length_row"]
SEED = -123456789


@pytest.mark.parametrize("t, lengths", CASES, ids=CASE_IDS)
def test_plain_with_dropout_and_lse_matches_jax_kernel(t, lengths):
    """Rate 0.1 at a fixed seed against the Pallas kernel's in-kernel
    dropout, and the LSE against the residual ``_flash_fwd`` (:711) saves,
    on valid rows."""
    b = 1 if lengths is None else len(lengths)
    q, k, v = _qkv(b, t, seed=t + 1)
    lens = np.full(b, t) if lengths is None else np.asarray(lengths)
    valid = np.arange(t)[None, :] < lens[:, None]
    key_mask = None if lengths is None else jnp.asarray(valid)
    seed = jnp.asarray([SEED], jnp.int32)
    want = np.asarray(flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask,
        block_q=128, block_k=128, interpret=True, dropout_rate=0.1, dropout_seed=seed,
    ))
    _, (*_, lse_want, meta) = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens, jnp.int32),
        seed, 128, 128, True, 0.1,
    )
    t_pad = meta[4]
    lse_want = np.asarray(lse_want).reshape(b, 2, t_pad)[:, :, :t]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = port.flash_attention(tq, tk, tv, tl, dropout_rate=0.1, seed=SEED).detach().numpy()
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=ATOL)
    assert np.all(got[~valid] == 0.0)
    o, lse = port.flash_attention_fwd(tq, tk, tv, tl, 0.1, SEED, return_lse=True)
    np.testing.assert_array_equal(o.numpy(), got)
    rows = np.broadcast_to(valid[:, None, :], lse.shape)
    np.testing.assert_allclose(lse.numpy()[rows], lse_want[rows], rtol=RTOL, atol=ATOL)
    assert np.all(lse.numpy()[~rows] == 0.0)
    # dropout changes the output; without it the LSE is the same
    _, lse0 = port.flash_attention_fwd(tq, tk, tv, tl, 0.0, None, return_lse=True)
    np.testing.assert_array_equal(lse0.numpy(), lse.numpy())
    assert not np.allclose(got[valid], port.flash_attention(tq, tk, tv, tl).numpy()[valid])


def test_dropout_needs_a_seed_and_a_rate_below_one():
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="requires a seed"):
        port.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"in \[0, 1\)"):
        port.flash_attention(q, q, q, dropout_rate=1.0, seed=0)


def test_backward_rounding_slack_covers_one_p_rounded_the_other_way():
    """dv with one P~ of a short row rounded to its other bf16 neighbour (as
    a kernel summing in another order may round it) stays within
    kernel_tolerance plus ``backward_rounding_slack``; the slack at that
    element is at least the moved amount, and it is 0 past the lengths and
    None in float32."""
    g = torch.Generator().manual_seed(3)
    b, t, h, lens = 2, 96, 2, torch.tensor([96, 12])
    q, k, v, do = (torch.randn(b, t, h, 64, generator=g).to(torch.bfloat16) for _ in range(4))
    q[1] *= 4  # peaked rows: P~ near 1/2, where one ulp is large
    o, lse = port.flash_attention_plain(q, k, v, lens, return_lse=True)
    args = (q, k, v, do, lse, port.attention_delta(o, do), lens)
    _, _, want = port.flash_attention_bwd_plain(*args)
    dk_slack, dv_slack = port.backward_rounding_slack(*args)
    assert dk_slack.shape == dv_slack.shape == want.shape and dv_slack.dtype == torch.float32
    assert torch.all(dv_slack[1, 12:] == 0) and torch.all(dk_slack[1, 12:] == 0) and dk_slack.max() > 0

    qs = q * port._scale(64, q.dtype)
    p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float()) - lse[..., None])
    pb = torch.where(torch.arange(t)[None, None, :, None] < lens[:, None, None, None], p, 0.0).to(torch.bfloat16)
    qi = int((pb[1, 0, :12, 0].float() * do[1, :12, 0, 0].float().abs()).argmax())  # the largest term
    bits = pb[1, 0, qi, 0].view(torch.int16)
    other = (bits + 1 if pb[1, 0, qi, 0].float() < p[1, 0, qi, 0] else bits - 1).view(torch.bfloat16)
    flipped = pb.clone()
    flipped[1, 0, qi, 0] = other
    got = torch.einsum("bhqk,bqhd->bkhd", flipped.float(), do.float()).to(torch.bfloat16)
    moved = (got[1, 0, 0].float() - want[1, 0, 0].float()).abs()
    assert moved.max() > 0 and torch.all(moved <= dv_slack[1, 0, 0] + port.kernel_tolerance(want)[0] * want[1, 0, 0].float().abs())
    valid = torch.arange(t)[None, :] < lens[:, None]
    rtol, atol = port.kernel_tolerance(want[valid], backward=True)
    err = (got[valid].float() - want[valid].float()).abs()
    assert torch.all(err <= atol + rtol * want[valid].float().abs() + dv_slack[valid])
    assert port.backward_rounding_slack(*(x.float() if x.is_floating_point() else x for x in args)) == (None, None)
