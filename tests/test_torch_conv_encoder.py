"""The port's fused strided conv against the JAX package's: the plain
version against ``strided_conv_fused`` (the Pallas kernel in interpret
mode) and ``conv_fused_reference`` at the JAX tests' shapes and limits,
its gradients against ``jax.vjp``, and ``ConvFeatureEncoder`` with
``conv_impl="fused_pallas"`` against the JAX encoder at identical weights.
Inputs come from numpy with a seed; float32 (and bfloat16 in and out) on
the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.ops import conv_encoder as jconv
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.ops import conv_encoder as tconv

C = 128


def _inputs(b, t_in, k, seed, bias=False, ln=False):
    """x [B, T_in, C], w [k, C, C] and the optional f32 bias / LN scale and
    bias, as numpy (the JAX tests' scales)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t_in, C)).astype(np.float32)
    w = (rng.normal(size=(k, C, C)) * (k * C) ** -0.5).astype(np.float32)
    extra = [
        rng.normal(size=(C,)).astype(np.float32) if bias else None,
        (1.0 + 0.1 * rng.normal(size=(C,))).astype(np.float32) if ln else None,
        rng.normal(size=(C,)).astype(np.float32) if ln else None,
    ]
    return x, w, extra


def _jnp(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


# (k, T_in, bias + LN, GELU, block_t, limits): the JAX tests' cases
# (tests/test_conv_encoder.py): ragged multi-tile T_in=97, a single partial
# tile T_in=21, LARGE's bias + LayerNorm at T_in=130, no GELU
CASES = {
    "k2_t97": (2, 97, False, True, 16, (2e-5, 2e-5)),
    "k3_t97": (3, 97, False, True, 16, (2e-5, 2e-5)),
    "k3_t21": (3, 21, False, True, 256, (2e-5, 2e-5)),
    "k3_t130_bias_ln": (3, 130, True, True, 32, (2e-4, 2e-5)),
    "k2_t130_bias_ln": (2, 130, True, True, 32, (2e-4, 2e-5)),
    "k2_t64_no_gelu": (2, 64, False, False, 16, (2e-5, 2e-5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_reference(case):
    k, t_in, affine, gelu, block_t, (rtol, atol) = CASES[case]
    x, w, extra = _inputs(2, t_in, k, seed=k + t_in, bias=affine, ln=affine)
    jargs = (_jnp(x), _jnp(w), *(_jnp(a) for a in extra))
    kernel = jconv.strided_conv_fused(*jargs, fuse_gelu=gelu, block_t=block_t, interpret=True)
    reference = jconv.conv_fused_reference(*jargs, fuse_gelu=gelu)
    got = tconv.strided_conv_fused(_torch(x), _torch(w), *(_torch(a) for a in extra),
                                   fuse_gelu=gelu)
    assert got.shape == (2, (t_in - k) // 2 + 1, C) and got.dtype == torch.float32
    for want in (kernel, reference):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "bias_ln"])
def test_bf16_in_and_out(affine):
    """bfloat16 x and w: one rounding to bf16 at the end, as the kernel;
    the JAX bf16 test's limit, 2e-2 / 2e-2."""
    x, w, extra = _inputs(2, 97, 3, seed=5, bias=affine, ln=affine)
    want = jconv.strided_conv_fused(_jnp(x, jnp.bfloat16), _jnp(w, jnp.bfloat16),
                                    *(_jnp(a) for a in extra), block_t=16, interpret=True)
    got = tconv.strided_conv_fused(_torch(x, torch.bfloat16), _torch(w, torch.bfloat16),
                                   *(_torch(a) for a in extra))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("k, t_in, affine", [(3, 65, False), (2, 33, True)],
                         ids=["k3_t65", "k2_t33_bias_ln"])
def test_gradients_match_jax_vjp(k, t_in, affine):
    """``StridedConvFusedFunction``'s gradients of x, w, bias and the LN
    parameters against ``jax.vjp`` of the JAX custom_vjp (interpret-mode
    forward): the JAX gradient tests' 1e-5 / 1e-5."""
    x, w, extra = _inputs(1, t_in, k, seed=9 + k, bias=affine, ln=affine)
    ct = np.random.default_rng(t_in).normal(size=(1, (t_in - k) // 2 + 1, C)).astype(np.float32)
    diff = [a for a in (x, w, *extra) if a is not None]

    def via_kernel(*args):
        x_, w_, *rest = args
        b_, s_, lb_ = rest if rest else (None, None, None)
        return jconv.strided_conv_fused(x_, w_, b_, s_, lb_, block_t=16, interpret=True)

    _, vjp = jax.vjp(via_kernel, *(_jnp(a) for a in diff))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_() for a in diff]
    x_t, w_t, *rest = leaves
    b_t, s_t, lb_t = rest if rest else (None, None, None)
    y = tconv.StridedConvFusedFunction.apply(x_t, w_t, b_t, s_t, lb_t, 1e-5, True)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(ct))
    assert len(got) == len(want) == (5 if affine else 2)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5, atol=1e-5)


def test_eligibility():
    for args in ((3, 2, 512, 512), (2, 2, 512, 512), (10, 5, 1, 512), (3, 1, 512, 512),
                 (3, 2, 512, 768), (3, 2, 100, 100), (2, 2, 128, 128)):
        assert tconv.eligible(*args) == jconv.eligible(*args), args
    assert tconv.eligible(3, 2, 512, 512) and not tconv.eligible(10, 5, 1, 512)


def test_wrapper_rejects_what_it_does_not_take():
    x, w = torch.zeros(1, 9, C), torch.zeros(3, C, C)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tconv.strided_conv_fused(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="come together"):
        tconv.strided_conv_fused(x, w, None, torch.ones(C), None)
    with pytest.raises(ValueError, match="C % 128"):
        tconv.strided_conv_fused(torch.zeros(1, 9, 96), torch.zeros(3, 96, 96))
    with pytest.raises(ValueError, match="k in"):
        tconv.strided_conv_fused(x, torch.zeros(4, C, C))
    with pytest.raises(ValueError, match="T_in >= k"):
        tconv.strided_conv_fused(torch.zeros(2, 2, C), w)
    before = tconv.strided_conv_fused.launches
    assert tconv.strided_conv_fused(x, w).shape == (1, 4, C)
    assert tconv.strided_conv_fused.launches == before  # the CPU runs the plain version


ENCODER = dict(conv_dim=(128,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2))
NORMS = {"group": dict(feat_extract_norm="group", conv_bias=False),
         "layer": dict(feat_extract_norm="layer", conv_bias=True)}


@functools.lru_cache(maxsize=None)
def _jax_encoder(norm):
    enc = jw.ConvFeatureEncoder(jw.Wav2Vec2Config(**ENCODER, **NORMS[norm], conv_impl="fused_pallas"))
    params = jax.jit(enc.init)(jax.random.PRNGKey(3), jnp.zeros((1, 2000)))["params"]
    return jax.jit(enc.apply), params


@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_fused_encoder_matches_jax(norm, padded):
    """Both packages' fused routes at identical weights, every frame, the
    JAX model test's 2e-4 / 2e-5; the port's two routes have the same
    parameter names."""
    apply, params = _jax_encoder(norm)
    rng = np.random.default_rng(1)
    lengths = [2000, 1337] if padded else [2000, 2000]
    mask = np.arange(2000)[None, :] < np.asarray(lengths)[:, None]
    wav = rng.normal(size=(2, 2000)).astype(np.float32) * mask
    want = apply({"params": params}, jnp.asarray(wav), jnp.asarray(mask) if padded else None)
    cfg = tw.Wav2Vec2Config(**ENCODER, **NORMS[norm], conv_impl="fused_pallas")
    enc = tw.ConvFeatureEncoder(cfg)
    enc.load_state_dict(params_from_jax(jax.device_get(params), cfg))
    with torch.no_grad():
        got = enc(torch.from_numpy(wav), torch.from_numpy(mask) if padded else None)
    assert got.shape == want.shape == (2, 99, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    xla = tw.ConvFeatureEncoder(tw.Wav2Vec2Config(**ENCODER, **NORMS[norm]))
    assert list(xla.state_dict()) == list(enc.state_dict())
