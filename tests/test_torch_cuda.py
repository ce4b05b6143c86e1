"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the attention forward (inference path, and with the LSE and dropout), the
dq and dk/dv backward kernels (in bf16 also at the shapes that stress the
K/V pipeline: LARGE's 16 heads, a key tile of one valid key, long rows
whose ring wraps; in float32 also against a float64 evaluation, two
launches bit-equal, and on row and head blocks bit-equal to the global
launch), the fused strided conv (f32 and bf16,
ragged last tiles, bias + LayerNorm, with and without GELU, and its
autograd Function), the int8 row quantize and GEMM (bit-equal to their
plain versions, ragged M, N and K, each tile width of the GEMM's launch
rule, a persistent walk that wraps, bf16 and f32 outputs, bit-equal across
launches) under ``QuantLinear``, and the CTC forward-backward (ragged frames and labels, a
repeated letter, an infeasible and an empty-label row, labels wider than a
block, the speaker CTC's V = 5995) within ``ops.ctc.kernel_tolerance``,
bit-equal across launches.

These tests need an NVIDIA card and ``nvcc``; without a card they skip.
The repository's ``tests/conftest.py`` imports JAX, which the card machine
need not have, so run them there without it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from w2v2_speaker_tpu_torch.ops import conv_encoder
from w2v2_speaker_tpu_torch.ops import ctc
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


def _inputs(cuda, dtype, t, lengths, seed, h=2):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    b = 2 if lengths is None else len(lengths)
    qkv = torch.randn(b, t, 3 * h * 64, generator=gen, device=cuda).to(dtype)
    q, k, v = (x.view(b, t, h, 64) for x in qkv.split(h * 64, dim=-1))
    do = torch.randn(b, t, h, 64, generator=gen, device=cuda).to(dtype)
    lens = None if lengths is None else torch.tensor(lengths, device=cuda)
    n = torch.full((b,), t, device=cuda) if lens is None else lens.clamp(0, t)
    valid = torch.arange(t, device=cuda)[None, :] < n[:, None]
    return q, k, v, do, lens, valid


def _close(got, want, valid, backward, slack=None):
    """Within fa.kernel_tolerance, plus for bf16 dk and dv the per-element
    ``slack`` of one rounding of P~ or dZ (fa.backward_rounding_slack)."""
    rtol, atol = fa.kernel_tolerance(want[valid], backward)
    err = (got[valid].float() - want[valid].float()).abs()
    limit = atol + rtol * want[valid].float().abs() + (0.0 if slack is None else slack[valid])
    assert torch.all(err <= limit), f"max error {err.max().item()}, {(err / limit).max().item():.3f} of the limit"
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
    for got, want, slack in zip((dq, dk, dv), fa.flash_attention_bwd_plain(*args),
                                (None, *fa.backward_rounding_slack(*args))):
        _close(got, want, valid, backward=True, slack=slack)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t, lengths, h", [
    (149, [149, 149, 120], 16),  # wav2vec2-LARGE's heads at the 3 s training length
    (129, [129, 129], 2),  # two full key tiles plus one key
])
def test_dkv_kernel_at_the_training_shapes(cuda, t, lengths, h, rate):
    """The dk/dv kernel in bf16 at LARGE's head count and at a key tile of
    one valid key, against the plain backward."""
    q, k, v, do, lens, valid = _inputs(cuda, torch.bfloat16, t, lengths, t + h, h)
    seed = 11 if rate else None
    o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=True)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), lens, rate, seed)
    before = fa.flash_attention_bwd_dkv.launches
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv.launches == before + 1
    _, want_dk, want_dv = fa.flash_attention_bwd_plain(*args)
    slack_dk, slack_dv = fa.backward_rounding_slack(*args)
    _close(dk, want_dk, valid, backward=True, slack=slack_dk)
    _close(dv, want_dv, valid, backward=True, slack=slack_dv)


PIPELINE_CASES = [
    (149, [149, 149, 120], 16),  # wav2vec2-LARGE's heads at the 3 s training length
    (129, [129, 129], 2),  # two full key tiles plus a tile of one valid key
    (1100, [1100, 1037], 2),  # 18 and 17 key tiles: the K/V ring wraps at both parities
]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t, lengths, h", PIPELINE_CASES)
def test_forward_and_dq_kernels_at_the_pipeline_shapes(cuda, t, lengths, h, rate):
    """The forward (o and LSE) and dq kernels in bf16 at LARGE's head count,
    at a key tile of one valid key and at long rows with an odd and an even
    number of key tiles, against their plain versions."""
    q, k, v, do, lens, valid = _inputs(cuda, torch.bfloat16, t, lengths, t + h, h)
    seed = 13 if rate else None
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=True)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), lens, rate, seed)
    dq = fa.flash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    want_o, want_lse = fa.flash_attention_plain(q, k, v, lens, rate, seed, return_lse=True)
    _close(o, want_o, valid, backward=False)
    rows = valid[:, None, :].expand_as(lse)
    torch.testing.assert_close(lse[rows], want_lse[rows], rtol=2e-4, atol=2e-5)
    assert torch.all(lse[~rows] == 0)
    _close(dq, fa.flash_attention_bwd_plain(*args)[0], valid, backward=True)


@pytest.mark.parametrize("t, lengths, h", [(t, n, 2) for t, n in CASES] + PIPELINE_CASES)
def test_inference_path_is_bit_equal_to_the_lse_path(cuda, t, lengths, h):
    """At rate 0 the inference instantiation (no LSE, no hash) and the
    training one (LSE) of the bf16 forward give the same bits."""
    q, k, v, _, lens, _ = _inputs(cuda, torch.bfloat16, t, lengths, t, h)
    o, _ = fa.flash_attention_fwd(q, k, v, lens, return_lse=True)
    assert torch.equal(fa.flash_attention(q, k, v, lens), o)


def test_autograd_through_the_kernels(cuda):
    """``flash_attention`` under autograd on the card: the forward and both
    backward kernels, against the plain backward of the same forward."""
    q, k, v, do, lens, valid = _inputs(cuda, torch.bfloat16, 149, [149, 90], 3)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(q, k, v, lens, dropout_rate=0.1, seed=5)
    got = torch.autograd.grad(o, (q, k, v), do)
    _, lse = fa.flash_attention_fwd(q, k, v, lens, 0.1, 5, return_lse=True)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), lens, 0.1, 5)
    for g, w, slack in zip(got, fa.flash_attention_bwd_plain(*args), (None, *fa.backward_rounding_slack(*args))):
        _close(g, w, valid, backward=True, slack=slack)


# the float32 dq and dk/dv kernels (3xTF32 wgmma): (T, lengths, H), lengths
# 0, 1, 64 and 65 (a key tile of one valid key), long rows, LARGE's heads
F32_BWD_CASES = [
    (149, [149, 64, 0], 2), (129, [129, 65, 1], 2), (65, [65, 64, 1], 16), (1100, [1100, 1037], 2),
]
# each float32 output's distance from the float64 evaluation (norm of the
# error over the norm) at most this many times the plain float32 version's
# (chip_smoke.ATTN_F64_FACTOR)
F64_FACTOR = 4.0


def _f32_backward(cuda, t, lengths, h, rate, seed):
    q, k, v, do, lens, valid = _inputs(cuda, torch.float32, t, lengths, seed, h)
    o, lse = fa.flash_attention_fwd(q, k, v, lens, rate, 29 if rate else None, return_lse=True)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), lens, rate, 29 if rate else None)
    return args, valid


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t, lengths, h", F32_BWD_CASES)
def test_f32_backward_kernels_keep_float32_accuracy(cuda, t, lengths, h, rate):
    """The float32 dq and dk/dv kernels against the plain version (within
    fa.kernel_tolerance, rows past the length exactly 0), against a
    float64 evaluation of the same formulas (within F64_FACTOR times the
    plain version's distance: 1xTF32 products would miss it), and against
    themselves (two launches bit-equal)."""
    args, valid = _f32_backward(cuda, t, lengths, h, rate, t + h)
    before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
    got = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    again = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches) == (
        before[0] + 2, before[1] + 2)
    for name, g, a, want, exact in zip(("dq", "dk", "dv"), got, again, fa.flash_attention_bwd_plain(*args),
                                       fa.attention_bwd_float64(*args)):
        _close(g, want, valid, backward=True)
        assert torch.equal(g, a), f"{name}: two launches differ"
        kernel_d, plain_d = fa.norm_distance(g, exact), fa.norm_distance(want, exact)
        assert kernel_d <= F64_FACTOR * plain_d, f"{name}: {kernel_d:.3e} from float64, plain {plain_d:.3e}"


@pytest.mark.parametrize("t, lengths, h", [(149, [149, 64, 0, 65], 16), (1100, [1100, 1037, 1, 700], 4)])
def test_f32_backward_kernels_on_row_and_head_blocks(cuda, t, lengths, h):
    """At rate 0.1, the float32 dq and dk/dv kernels on a block of rows and
    on a block of heads, at their global coordinates, give the bits of the
    same rows and heads of the global launch."""
    args, _ = _f32_backward(cuda, t, lengths, h, 0.1, t)
    q, k, v, do, lse, delta, lens, rate, seed = args
    want = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    b0, h0 = len(lengths) // 2, h // 2
    for rows, heads, coords in ((slice(b0, None), slice(None), (b0, 0, 0)), (slice(None), slice(h0, None), (0, h0, h))):
        block = (*(x[rows, :, heads] for x in (q, k, v, do)), *(x[rows, heads].contiguous() for x in (lse, delta)),
                 lens[rows], rate, seed)
        got = (fa.flash_attention_bwd_dq(*block, coords=coords), *fa.flash_attention_bwd_dkv(*block, coords=coords))
        for g, w in zip(got, want):
            assert torch.equal(g, w[rows, :, heads]), f"block {coords} differs from the global launch"


# the fused strided conv (csrc/conv_encoder.cu): (B, T_in, C, k, bias + LN)
CONV_CASES = [
    (2, 97, 128, 2, False), (2, 97, 128, 3, True), (3, 21, 128, 3, False),  # ragged last tiles
    (2, 130, 256, 3, True), (1, 600, 512, 2, True), (2, 1199, 512, 3, False),  # wav2vec2 widths
    # odd T_in whose T_out is one frame past a 64-frame tile (65, 129)
    (3, 131, 384, 3, True), (4, 131, 384, 2, False), (3, 131, 512, 3, True), (5, 259, 128, 3, True),
]


def _conv_inputs(cuda, b, t_in, c, k, affine, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, t_in, c, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(k, c, c, generator=gen, device=cuda) * (k * c) ** -0.5).to(dtype)
    extra = [None, None, None]
    if affine:
        extra = [torch.randn(c, generator=gen, device=cuda),
                 1 + 0.1 * torch.randn(c, generator=gen, device=cuda),
                 torch.randn(c, generator=gen, device=cuda)]
    return x, w, extra


@pytest.mark.parametrize("gelu", [True, False], ids=["gelu", "no_gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, t_in, c, k, affine", CONV_CASES)
def test_conv_kernel_matches_plain(cuda, dtype, b, t_in, c, k, affine, gelu):
    x, w, extra = _conv_inputs(cuda, b, t_in, c, k, affine, dtype, seed=t_in + k)
    before = conv_encoder.strided_conv_fused.launches
    got = conv_encoder.strided_conv_fused(x, w, *extra, fuse_gelu=gelu)
    torch.cuda.synchronize()
    assert conv_encoder.strided_conv_fused.launches == before + 1
    want = conv_encoder.conv_fused_reference(x, w, *extra, fuse_gelu=gelu)
    assert got.shape == want.shape == (b, (t_in - k) // 2 + 1, c) and got.dtype == dtype
    rtol, atol = conv_encoder.kernel_tolerance(want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_conv_kernel_rejects_what_it_does_not_take(cuda):
    x, w = torch.zeros(1, 9, 128, device=cuda, dtype=torch.float16), torch.zeros(3, 128, 128)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        conv_encoder.strided_conv_fused(x, w)
    x = torch.zeros(1, 9, 640, device=cuda)
    with pytest.raises(ValueError, match="C <= 512"):
        conv_encoder.strided_conv_fused(x, torch.zeros(3, 640, 640, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_function_gradients_match_plain(cuda, dtype):
    """``StridedConvFusedFunction`` on the card (kernel forward, recomputed
    plain backward) against autograd of the plain version on the same
    inputs: the forward within the kernel's limit, the gradients close to
    float32 rounding (the backward is the same computation)."""
    x, w, extra = _conv_inputs(cuda, 2, 97, 256, 3, True, dtype, seed=4)
    w32 = w.float().requires_grad_()
    leaves = [x.requires_grad_(), w32, *(e.requires_grad_() for e in extra)]
    y = conv_encoder.StridedConvFusedFunction.apply(x, w32, *extra, 1e-5, True)
    g = torch.randn(y.shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    got = torch.autograd.grad(y, leaves, g.to(dtype))
    want_y = conv_encoder.conv_fused_reference(x, w32, *extra)
    want = torch.autograd.grad(want_y, leaves, g.to(dtype))
    rtol, atol = conv_encoder.kernel_tolerance(want_y)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol, atol=atol)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("recipe", ["speaker_wav2vec2_ce", "speaker_wav2vec2_large_aam"])
def test_layer_norm_outputs_are_bf16_in_a_bf16_training_forward(cuda, recipe):
    """CUDA autocast runs ``layer_norm`` in float32 and returns float32; the
    port's ``LayerNorm`` rounds its output to bf16, as the JAX package's
    ``LayerNorm(dtype=bf16)`` does, so nothing downstream (the BASE
    residual stream, the conv GELUs, LARGE's final norm) runs in float32.
    The recipe at full width and 2 layers, one training forward."""
    from w2v2_speaker_tpu_torch.entry import build_train_state, synthetic_batch
    from w2v2_speaker_tpu_torch.models.wav2vec2 import LayerNorm
    from w2v2_speaker_tpu_torch.runtime.experiment import load_recipe

    state, task = build_train_state(cuda, "bf16", load_recipe(recipe), seed=0, num_layers=2)
    seen = {}
    for name, module in state.model.named_modules():
        if isinstance(module, torch.nn.LayerNorm):
            assert isinstance(module, LayerNorm), name
            module.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    batch = {k: v[0] for k, v in synthetic_batch(2, 16000, cuda, seed=0).items()}
    task.loss_fn(batch, state.generator, train=True)
    kept = state.model.wav2vec2.encoder.layers_run
    # BASE: feature projection, encoder input, 2 per kept layer; LARGE: the
    # 7 conv norms too (cuDNN route), and the final encoder norm
    want = 2 + 2 * kept if recipe == "speaker_wav2vec2_ce" else 9 + 2 * kept
    assert len(seen) == want, sorted(seen)
    assert set(seen.values()) == {torch.bfloat16}, seen


def test_triplet_mining_stays_on_the_card(cuda):
    """Labels on the card and the step's CPU generator: the picks are drawn
    on the card (no host copy of the labels), valid, and the same for the
    same generator state."""
    from w2v2_speaker_tpu_torch.objectives.losses import mine_triplets

    labels = torch.tensor([0, 0, 1, 1, 1, 2, 2, 0], device=cuda)
    pos, neg = mine_triplets(labels, torch.Generator().manual_seed(3))
    assert pos.device.type == neg.device.type == "cuda"
    assert torch.all(labels[pos] == labels) and torch.all(pos != torch.arange(8, device=cuda))
    assert torch.all(labels[neg] != labels)
    again = mine_triplets(labels, torch.Generator().manual_seed(3))
    assert torch.equal(again[0], pos) and torch.equal(again[1], neg)


# (M, N, K) of the GEMM's launch rule's four tile widths on an H100 (132 SMs)
INT8_TILE_SHAPES = {64: (300, 768, 256), 128: (1280, 1536, 256), 192: (7152, 768, 128), 256: (5796, 4096, 128)}
INT8_SHAPES = [
    (300, 768, 768), (7, 96, 64), (129, 130, 40), (1, 3072, 4096),
    (333, 1000, 512),  # M and N off every tile size
    (200, 40, 128),  # N smaller than one tile
    (130, 200, 16), (257, 300, 4096 + 16),  # K of one 16-byte step; K one step past 4096
    (50, 64, 203),  # rows not 16-byte aligned: the quantize's element-wise loads, K padded to 208
    (5, 70, 40000),  # rows longer than the quantize's registers hold (read in chunks)
    (2000, 4096, 256),  # 256 tiles of 128 x 256 on 132 SMs: the persistent walk wraps
    *INT8_TILE_SHAPES.values(),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m, n, k", INT8_SHAPES)
def test_int8_kernels_are_bit_equal_to_plain(cuda, dtype, m, n, k):
    """The row quantize (values and scales, with a zero row and rows that
    land on k + 0.5) and the GEMM with its rescale and bias: the int32 sums
    are exact and the epilogue's float32 order is the plain version's, so
    every output bit agrees."""
    from w2v2_speaker_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    x[0] = 0.0
    if m > 2:
        x[1] = torch.arange(k, device=cuda, dtype=torch.float32).remainder(5).sub(2).mul(0.5).to(dtype)
        x[1, 0] = 127.0  # scale 1: x / scale lands on the halves
    w = (torch.randn(n, k, generator=gen, device=cuda) * 0.05).to(dtype)
    bias = torch.randn(n, generator=gen, device=cuda)
    before = (quant.quantize_rows.launches, quant.int8_gemm.launches)
    xq, xs = quant.quantize_rows(x)
    wq, ks = quant.quantize_rows(w)
    torch.cuda.synchronize()
    for (got_q, got_s), t in (((xq, xs), x), ((wq, ks), w)):
        want_q, want_s = quant.quantize_rows_reference(t)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    assert xs[0] == 1 and torch.all(xq[0] == 0)
    for b in (bias, None):
        got = quant.int8_gemm(xq, wq, xs, ks, b, dtype)
        want = quant.int8_gemm_reference(xq, wq, xs, ks, b, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), (got.float() - want.float()).abs().max()
    assert (quant.quantize_rows.launches, quant.int8_gemm.launches) == (before[0] + 2, before[1] + 2)


def test_int8_kernels_repeat_bit_for_bit(cuda):
    """Two launches of each kernel on the same inputs agree bit for bit (a
    grid that wraps the persistent walk, both output types), and the
    launch rule takes each of its four tile widths at INT8_TILE_SHAPES."""
    from w2v2_speaker_tpu_torch.ops import quant

    assert {bn: quant.gemm_tile(m, n) for bn, (m, n, _) in INT8_TILE_SHAPES.items()} == {
        bn: (128, bn) for bn in INT8_TILE_SHAPES}
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2000, 1024, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn(4096, 1024, generator=gen, device=cuda) * 0.03
    bias = torch.randn(4096, generator=gen, device=cuda)
    first = [quant.quantize_rows(x), quant.quantize_rows(w)]
    second = [quant.quantize_rows(x), quant.quantize_rows(w)]
    for a, b in zip(first, second):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    (xq, xs), (wq, ks) = first
    for dtype in (torch.bfloat16, torch.float32):
        got = [quant.int8_gemm(xq, wq, xs, ks, bias, dtype) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1])


def test_quant_linear_on_the_card(cuda):
    """``QuantLinear`` under bf16 autocast over float32 weights: the bf16
    output of the kernels equals the plain version's on the same inputs
    (run on the CPU), and a forward that needs a gradient raises."""
    from w2v2_speaker_tpu_torch.ops import quant

    layer = quant.QuantLinear(256, 384).to(cuda)
    x = torch.randn(3, 50, 256, device=cuda)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        got = layer(x)
    with torch.no_grad():
        want = quant.int8_matmul(x.to(torch.bfloat16).cpu(), layer.weight.cpu(), layer.bias.cpu(), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 50, 384)
    assert torch.equal(got.cpu(), want)
    with pytest.raises(RuntimeError, match="inference only"):
        layer(x)


CTC_CASES = {  # (logit lengths, label lengths, T, V, S)
    "ragged": ((300, 251, 120, 40, 5), (110, 70, 61, 0, 8), 300, 32, 120),  # row 3 empty, row 4 infeasible
    "wide_labels": ((700, 640), (300, 280), 700, 32, 300),  # 601 states: 301 pairs, 10 warps a row
    "long_labels": ((2300, 2250), (1100, 1050), 2300, 32, 1100),  # 2201 states: 2 pairs a thread
    "speaker": ((149,) * 4, (1,) * 4, 149, 5995, 1),
}


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_kernels_match_plain(cuda, case):
    """The forward ``ctc_alpha_beta`` (one launch: alpha and beta) and
    ``ctc_grad`` against their plain versions on the same inputs, with the
    main path's upstream weights (1 / label length over the non-empty
    rows): logp within ``kernel_tolerance``'s loss limit and the logit
    gradient within its gradient limit on feasible rows, alpha and beta at
    the rows' frames and states (``log_space`` of the kernel's pairs)
    within 1e-9 of the plain log-space recursions, exact zeros on the
    infeasible row and past each row's frames, two launches bit-equal."""
    tl, ll, t, v, s = CTC_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(tl))
    b = len(tl)
    lp = torch.log_softmax(torch.randn(b, t, v, generator=gen, device=cuda) * 2, -1)
    labels = torch.randint(1, v, (b, s), generator=gen, device=cuda, dtype=torch.int32)
    labels[0, 1::7] = labels[0, 0:-1:7]  # repeated letters: a blank between
    lens = torch.tensor(tl, device=cuda, dtype=torch.int32)
    label_lens = torch.tensor(ll, device=cuda, dtype=torch.int32)
    labels *= (torch.arange(s, device=cuda)[None] < label_lens[:, None]).to(torch.int32)
    valid = (label_lens > 0).float()
    g = valid / label_lens.clamp_min(1).float() / valid.sum()
    rtol, gatol = ctc.kernel_tolerance()
    before = ctc.ctc_alpha_beta.launches, ctc.ctc_grad.launches
    alpha, beta, logp = ctc.ctc_alpha_beta(lp, lens, labels, label_lens)
    grad = ctc.ctc_grad(lp, alpha, beta, logp, g, lens, labels, label_lens)
    again = ctc.ctc_grad(lp, *ctc.ctc_alpha_beta(lp, lens, labels, label_lens), g, lens, labels, label_lens)
    torch.cuda.synchronize()
    assert (ctc.ctc_alpha_beta.launches, ctc.ctc_grad.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(grad, again)
    want_alpha, want_logp = ctc.ctc_alpha_reference(lp, lens, labels, label_lens)
    want_beta = ctc.ctc_beta_reference(lp, lens, labels, label_lens)
    want = ctc.ctc_grad_reference(lp, want_alpha, want_beta, want_logp, g, lens, labels, label_lens)
    feasible = torch.isfinite(want_logp)
    assert torch.equal(torch.isfinite(logp), feasible)
    torch.testing.assert_close(logp[feasible], want_logp[feasible], rtol=rtol, atol=0)
    torch.testing.assert_close(grad, want, rtol=0, atol=gatol)
    frames = torch.arange(t, device=cuda)[None, :] < lens[:, None]
    assert torch.all(grad[~frames] == 0) and torch.all(grad[~feasible] == 0)
    cells = frames[:, :, None] & (torch.arange(2 * s + 1, device=cuda)[None, None] < 2 * label_lens[:, None, None] + 1)
    for got, ref in ((alpha, want_alpha), (beta, want_beta)):
        got = ctc.log_space(got)
        assert torch.equal(torch.isinf(got[cells]), torch.isinf(ref[cells]))
        finite = cells & torch.isfinite(ref)
        torch.testing.assert_close(got[finite], ref[finite], rtol=1e-9, atol=1e-9)
    if case == "ragged":
        assert not feasible[4] and feasible[:4].all()
