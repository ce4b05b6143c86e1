"""A LARGE-layout speaker model with the fused conv route and the AAM head,
one training step of the port against the JAX package's
``make_train_step(SpeakerTask(..., mode="aam"))`` at identical weights and
batch, float32 on the CPU, every regularisation rate at 0: the loss, the
accuracy, the gradients (``aam.weights`` among them) and
``compute_embedding``. The JAX fused conv runs its Pallas kernel in
interpret mode off the TPU, as the JAX package's own tests run it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.train import speaker_task as jtask
from w2v2_speaker_tpu.train import state as jstate
from w2v2_speaker_tpu.train import steps as jsteps
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.ops import conv_encoder as tconv
from w2v2_speaker_tpu_torch.train import speaker_task as ttask
from w2v2_speaker_tpu_torch.train import state as tstate
from w2v2_speaker_tpu_torch.train import steps as tsteps

TINY_LARGE = dict(  # LARGE's layout at tiny width, fused conv layers 1-2
    conv_dim=(128,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2), conv_bias=True,
    feat_extract_norm="layer", do_stable_layer_norm=True, hidden_size=32, num_layers=2,
    num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, layerdrop=0.0, mask_time_prob=0.0, hidden_dropout=0.0,
    attention_dropout=0.0, feat_proj_dropout=0.0, conv_impl="fused_pallas",
)
HEAD = dict(stat_pooling_type="mean", use_aam=True, aam_margin=0.2, aam_scale=30.0)
N_SPK, N = 12, 1600
LENGTHS = [1600, 1310, 1020, 700]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # tests/test_torch_train_step.py's limits
EMB_RTOL, EMB_ATOL = 1e-4, 1e-5


def _batch(seed):
    rng = np.random.default_rng(seed)
    wav = rng.normal(0, 0.5, (len(LENGTHS), N)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(LENGTHS)[:, None]
    return {"features": wav * mask, "mask": mask, "labels": rng.integers(0, N_SPK, len(LENGTHS))}


@functools.lru_cache(maxsize=None)
def _jax_init():
    model = js.Wav2Vec2SpeakerModel(
        cfg=js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY_LARGE), **HEAD),
        num_speakers=N_SPK,
    )
    task = jtask.SpeakerTask(model=model, mode="aam")
    params, model_state = task.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _batch(0)))
    return task, jax.device_get(params), model_state


def _torch_model():
    _, params, _ = _jax_init()
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY_LARGE), **HEAD)
    model = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=N_SPK)
    model.load_state_dict(params_from_jax(params, cfg))
    return model, cfg


def test_aam_step_matches_jax():
    task, params, model_state = _jax_init()
    batch = _batch(1)
    jb = jax.tree.map(jnp.asarray, batch)
    want_grads = jax.jit(jax.grad(
        lambda p: task.loss_fn(p, model_state, jb, jax.random.PRNGKey(2))[0]))(params)
    state = jstate.TrainState.create(
        apply_fn=task.model.apply, params=jax.tree.map(jnp.asarray, params),
        tx=optax.adam(1e-3), model_state=model_state, rng=jax.random.PRNGKey(1),
    )
    _, want = jsteps.make_train_step(task)(state, jb)

    model, cfg = _torch_model()
    tstate_ = tstate.TrainState.create(model, tstate.AdamTx(lambda s: 1e-3), seed=0)
    step = tsteps.make_train_step(ttask.SpeakerTask(model, "aam"))
    before = tconv.strided_conv_fused.launches
    _, got = step(tstate_, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tconv.strided_conv_fused.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
    assert got["accuracy"].item() == pytest.approx(float(want["accuracy"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    want_g = params_from_jax(jax.device_get(want_grads), cfg)
    assert set(want_g) == set(grads) and "aam.weights" in grads
    assert "head.fc_out.weight" not in grads  # the AAM head replaces the output layer
    for name, g in want_g.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_aam_compute_embedding_matches_jax():
    task, params, model_state = _jax_init()
    batch = _batch(3)
    embed = jax.jit(functools.partial(task.model.apply,
                                      method=js.Wav2Vec2SpeakerModel.compute_embedding))
    want = embed({"params": params, **model_state}, jnp.asarray(batch["features"]),
                 jnp.asarray(batch["mask"]))
    model, _ = _torch_model()
    # params_from_jax passes the flax aam/weights [classes, D] through untransposed
    np.testing.assert_array_equal(model.aam.weights.detach().numpy(), params["aam"]["weights"])
    with torch.no_grad():
        got = model.eval().compute_embedding(torch.from_numpy(batch["features"]),
                                             torch.from_numpy(batch["mask"]))
    assert got.shape == (len(LENGTHS), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EMB_RTOL, atol=EMB_ATOL)
