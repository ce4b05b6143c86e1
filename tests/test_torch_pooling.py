"""The port's pooling zoo (``models/pooling.py``) against the JAX
package's on the CPU: every ``stat_pooling_type`` on the same masked
input, ``attentive``'s BatchNorm in training (output and running
statistics after two steps), ``first+cls`` through ``Wav2Vec2SpeakerModel``
in float32 and bfloat16, ``random``'s frame index, and an ``attentive``
checkpoint of the JAX package served by the port with its running
statistics.

Limits: pooled outputs 1e-5 / 1e-6 (float32, the same math in other
summation orders); BatchNorm output and running statistics 1e-6; the
embeddings of ``first+cls`` and of the served checkpoint 1e-5 / 1e-5 in
float32 (readings 6e-6 relative, 1.4e-6 absolute at most), and
``first+cls``'s 0.02 of the largest embedding in bfloat16
(``tests/test_torch_bf16_parity.py``'s limit)."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.models import pooling as jp
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu_torch.models import pooling as tp
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
EMB_RTOL, EMB_ATOL = 1e-5, 1e-5
BF16_LIMIT = 0.02
NAMES = ("mean", "mean+std", "quantile", "max", "attentive", "first", "first+cls", "middle", "last", "random",
         "none")
B, T, F = 3, 9, 8
LENGTHS = [9, 5, 1]
TINY = dict(
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32, num_layers=2,
    num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    layerdrop=0.0,
)


def _input(seed=0, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, F)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(LENGTHS)[:, None]
    return x, (mask if masked else None)


def _attentive_variables(seed=0):
    """The JAX AttentiveStatPool's params with random running statistics."""
    x, mask = _input()
    variables = jp.AttentiveStatPool().init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask))
    rng = np.random.default_rng(seed + 1)
    stats = {"attn_bn": {"mean": rng.normal(0, 0.3, 128).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, 128).astype(np.float32)}}
    return jax.device_get(variables["params"]), stats


def _torch_attentive(params, stats):
    pool = tp.AttentiveStatPool(F)
    pool.load_state_dict(params_from_jax(params, tw.Wav2Vec2Config(), stats), strict=True)
    return pool


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("name", NAMES)
def test_pooling_matches_jax(name, masked):
    x, mask = _input(masked=masked)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    if name == "attentive":
        params, stats = _attentive_variables()
        want = jp.AttentiveStatPool().apply({"params": params, "batch_stats": stats}, jnp.asarray(x), jmask)
        pool = _torch_attentive(params, stats)
    else:
        want = jp.get_pooling(name).apply({}, jnp.asarray(x), jmask)
        pool = tp.get_pooling(name, F)
    with torch.no_grad():
        got = pool(torch.from_numpy(x), tmask)
    assert tuple(got.shape) == want.shape
    assert want.shape[-1] == tp.pooled_embedding_size(name, F) == jp.pooled_embedding_size(name, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_padding_invariance():
    """Each row pools as it does alone and unpadded, for every name."""
    x, mask = _input()
    params, stats = _attentive_variables()
    for name in NAMES[:-1]:
        pool = _torch_attentive(params, stats) if name == "attentive" else tp.get_pooling(name, F)
        with torch.no_grad():
            batch = pool(torch.from_numpy(x), torch.from_numpy(mask))
            for i, n in enumerate(LENGTHS):
                alone = pool(torch.from_numpy(x[i:i + 1, :n]))
                torch.testing.assert_close(batch[i:i + 1], alone, rtol=RTOL, atol=ATOL, msg=name)


def test_attentive_batch_norm_trains_as_flax():
    """Two training steps of ``attentive`` (mutable batch_stats in JAX):
    the outputs and the running mean and variance after each."""
    x, mask = _input(seed=3)
    params, stats = _attentive_variables(seed=4)
    pool = _torch_attentive(params, stats)
    variables = {"params": params, "batch_stats": stats}
    for step in range(2):
        xs = x + step
        want, mutated = jp.AttentiveStatPool().apply(variables, jnp.asarray(xs), jnp.asarray(mask), train=True,
                                                     mutable=["batch_stats"])
        variables = {"params": params, **jax.device_get(mutated)}
        got = pool(torch.from_numpy(xs), torch.from_numpy(mask), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        for jname, tname in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(getattr(pool.attn_bn, tname).numpy(),
                                       variables["batch_stats"]["attn_bn"][jname], rtol=1e-6, atol=1e-6)


def test_batch_norm_is_not_torchs():
    """The biased variance over every position, momentum 0.9 on the old
    value: what ``nn.BatchNorm1d`` would not give."""
    bn = tp.BatchNorm(4)
    h = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(0))
    bn(h, train=True)
    flat = h.reshape(-1, 4)
    torch.testing.assert_close(bn.running_mean, 0.1 * flat.mean(0))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * flat.var(0, unbiased=False))


def test_random_index():
    """Eval: lengths // 2 exactly, as ``middle``. Training: a frame drawn
    from the generator, in [0, length) of each row."""
    x, mask = _input()
    pool = tp.get_pooling("random", F)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    want = x[np.arange(B), np.asarray(LENGTHS) // 2]
    np.testing.assert_array_equal(pool(xt, mt).numpy(), want)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        got = pool(xt, mt, train=True, generator=gen).numpy()
        for i, n in enumerate(LENGTHS):
            assert any(np.array_equal(got[i], x[i, j]) for j in range(n)), (i, got[i])
    with pytest.raises(ValueError, match="Generator"):
        pool(xt, mt, train=True)


@functools.lru_cache(maxsize=None)
def _cls_models(dtype):
    head = dict(stat_pooling_type="first+cls", hidden_fc_layers_out=(24,), embedding_layer_idx=0)
    jm = js.Wav2Vec2SpeakerModel(cfg=js.Wav2Vec2SpeakerConfig(
        w2v2=jw.Wav2Vec2Config(**TINY, dtype=dtype, attention_impl="xla"), **head), num_speakers=8)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(5), jnp.zeros((1, 1600)))
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY, dtype=dtype), **head)
    tm = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=8).eval()
    tm.load_state_dict(params_from_jax(jax.device_get(variables["params"]), cfg), strict=True)
    embed = jax.jit(functools.partial(jm.apply, method=js.Wav2Vec2SpeakerModel.compute_embedding))
    return embed, variables, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_cls_embeddings_match_jax(dtype):
    """``first+cls`` pools the CLS row the backbone puts in front: the
    embeddings of a padded batch against the JAX model's."""
    embed, variables, tm = _cls_models(dtype)
    rng = np.random.default_rng(6)
    lengths = [1600, 1210, 843]
    mask = np.arange(1600)[None, :] < np.asarray(lengths)[:, None]
    wav = rng.normal(0, 0.5, (3, 1600)).astype(np.float32) * mask
    want = np.asarray(embed(variables, jnp.asarray(wav), jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        got = tm.compute_embedding(torch.from_numpy(wav), torch.from_numpy(mask)).float().numpy()
        feats, fmask = tm.wav2vec2(torch.from_numpy(wav), torch.from_numpy(mask))
    assert feats.shape[1] == fmask.shape[1] and bool(fmask[:, 0].all())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=EMB_RTOL, atol=EMB_ATOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= BF16_LIMIT


def test_attentive_checkpoint_serves_the_jax_embeddings(tmp_path):
    """A JAX-package checkpoint of an ``attentive`` model whose running
    statistics moved in training, exported with ``tools/export_jax_params.py``
    and loaded by ``load_params``: the port serves the embeddings that the
    JAX model computes from the checkpoint's params and batch_stats. With
    the statistics left at their initial values it would not."""
    import importlib.util

    import optax

    from w2v2_speaker_tpu.train import speaker_task as jtask
    from w2v2_speaker_tpu.train.checkpoint import CheckpointManager
    from w2v2_speaker_tpu.train.state import TrainState
    from w2v2_speaker_tpu_torch.train.checkpoint import load_params

    head = dict(stat_pooling_type="attentive", hidden_fc_layers_out=(24,), embedding_layer_idx=0)
    w2v2 = dict(TINY, hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0)
    jm = js.Wav2Vec2SpeakerModel(cfg=js.Wav2Vec2SpeakerConfig(
        w2v2=jw.Wav2Vec2Config(**w2v2, attention_impl="xla"), **head), num_speakers=8)
    task = jtask.SpeakerTask(model=jm)
    rng = np.random.default_rng(7)
    mask = np.arange(1600)[None, :] < np.asarray([1600, 1300, 900])[:, None]
    batch = {"features": jnp.asarray(rng.normal(0, 0.5, (3, 1600)).astype(np.float32) * mask),
             "mask": jnp.asarray(mask), "labels": jnp.asarray([0, 1, 2])}
    params, model_state = task.init(jax.random.PRNGKey(1), batch)
    for _ in range(2):  # training forwards move the running statistics
        _, aux = task.loss_fn(params, model_state, batch, jax.random.PRNGKey(2), train=True)
        model_state = aux["model_state"]
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=optax.adam(1e-3), model_state=model_state)
    CheckpointManager(tmp_path / "ckpt").save_step(state, {"val_eer": 0.5}, epoch=0)
    spec = importlib.util.spec_from_file_location("export_jax_params", ROOT / "tools" / "export_jax_params.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    flat = export.export(tmp_path / "ckpt" / "best", tmp_path / "w.npz")
    assert "batch_stats/stat_pooling/attn_bn/mean" in flat

    want = np.asarray(jm.apply({"params": params, **model_state}, batch["features"], batch["mask"],
                               method=js.Wav2Vec2SpeakerModel.compute_embedding))
    tm = ts.Wav2Vec2SpeakerModel(ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**w2v2), **head), num_speakers=8)
    tw.init_parameters(tm, torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in tm.state_dict().items()}
    load_params(tmp_path / "w.npz", tm)
    features, fmask = torch.from_numpy(np.array(batch["features"])), torch.from_numpy(mask)
    with torch.no_grad():
        got = tm.compute_embedding(features, fmask).numpy()
        np.testing.assert_allclose(got, want, rtol=EMB_RTOL, atol=EMB_ATOL)
        tm.load_state_dict({**tm.state_dict(), **{k: fresh[k] for k in fresh if "running" in k}})
        stale = tm.compute_embedding(features, fmask).numpy()
    assert np.abs(stale - want).max() > 100 * EMB_ATOL
