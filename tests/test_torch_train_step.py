"""One training step of the port against the JAX package's
``make_train_step(SpeakerTask(...))`` at identical weights and batch, float32
on the CPU, all regularisation rates at 0: loss, gradients and the updated
parameters, plain, with gradient accumulation and with the freeze schedule.
Also: padding invariance of the gradients, the step's own contracts, and
the recipe's config, composed from ``config/``, against the YAML files."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from test_torch_run import one_thread  # noqa: F401 (one_thread: autouse, one intra-op thread)
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.objectives import schedules as jschedules
from w2v2_speaker_tpu.train import speaker_task as jtask
from w2v2_speaker_tpu.train import state as jstate
from w2v2_speaker_tpu.train import steps as jsteps
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.models import wav2vec2_speaker as ts
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.objectives import schedules as tschedules
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train import speaker_task as ttask
from w2v2_speaker_tpu_torch.train import state as tstate
from w2v2_speaker_tpu_torch.train import steps as tsteps

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(  # __graft_entry__.py:130-140, every rate at 0
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32,
    num_layers=2, num_heads=4, intermediate_size=64, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, layerdrop=0.0, mask_time_prob=0.0,
    hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
N_SPK, N = 16, 1600
LENGTHS = [1600, 1310, 1020, 700]
MAX_LR, TOTAL = 1e-3, 100
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # the JAX attention backward tests' f32 limits
# Updated parameters. Adam's first updates are lr * g / (|g| + eps), about
# lr * sign(g): where |g| is above SMALL_GRAD both packages move a weight by
# the same lr-sized step, to float32 rounding of the weights (~1e-7) plus
# lr times Adam's sensitivity to the gradient error there (~1e-8), so
# PARAM_ATOL; where |g| is within the gradients' own error of 0 the sign may
# differ, and the two weights are only within the update's bound, 2 lr per
# step.
SMALL_GRAD, PARAM_ATOL = 1e-4, 1e-6


def _batch(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    wav = rng.normal(0, 0.5, (len(lengths), N)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(lengths)[:, None]
    return {"features": wav * mask, "mask": mask, "labels": rng.integers(0, N_SPK, len(lengths))}


@functools.lru_cache(maxsize=None)
def _jax_init():
    model = js.Wav2Vec2SpeakerModel(
        cfg=js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**TINY), stat_pooling_type="mean"),
        num_speakers=N_SPK,
    )
    task = jtask.SpeakerTask(model=model, mode="ce")
    params, model_state = task.init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _batch(0)))
    return task, jax.device_get(params), model_state


def _torch_model(params):
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY), stat_pooling_type="mean")
    model = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=N_SPK)
    model.load_state_dict(params_from_jax(params, cfg))
    return model, cfg


@jax.jit
def _jax_grad(params, batch):
    task, _, model_state = _jax_init()
    return jax.grad(lambda p: task.loss_fn(p, model_state, batch, jax.random.PRNGKey(2))[0])(params)


def _jax_run(batches, acc=1, frozen_steps=None):
    """(params after each step, losses, grads of each step)."""
    task, params, model_state = _jax_init()
    tx = optax.adam(jschedules.one_cycle(MAX_LR, TOTAL))
    if frozen_steps is not None:
        tx = jstate.make_freeze_schedule_tx(tx, lambda p: p.startswith("wav2vec2"), frozen_steps)
    state = jstate.TrainState.create(
        apply_fn=task.model.apply, params=jax.tree.map(jnp.asarray, params), tx=tx,
        model_state=model_state, rng=jax.random.PRNGKey(1),
    )
    step = jsteps.make_train_step(task, accumulate_steps=acc)
    out_params, losses, grads = [], [], []
    for b in batches:
        jb = jax.tree.map(jnp.asarray, b)
        # with equal microbatches and every rate at 0, the mean of their
        # gradients is the whole batch's gradient
        g = _jax_grad(state.params, jb)
        state, metrics = step(state, jb)
        out_params.append(jax.device_get(state.params))
        losses.append(float(metrics["loss"]))
        grads.append(jax.device_get(g))
    return out_params, losses, grads


def _torch_run(batches, acc=1, frozen_steps=None):
    _, params, _ = _jax_init()
    model, cfg = _torch_model(params)
    tx = tstate.AdamTx(tschedules.one_cycle(MAX_LR, TOTAL))
    if frozen_steps is not None:
        tx = tstate.make_freeze_schedule_tx(tx, lambda p: p.startswith("wav2vec2"), frozen_steps)
    state = tstate.TrainState.create(model, tx, seed=0)
    step = tsteps.make_train_step(ttask.SpeakerTask(model, "ce"), accumulate_steps=acc)
    out_params, losses, grads = [], [], []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out_params.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        losses.append(metrics["loss"].item())
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
    return out_params, losses, grads, cfg


def _compare(batches, acc=1, frozen_steps=None):
    j_params, j_losses, j_grads = _jax_run(batches, acc, frozen_steps)
    t_params, t_losses, t_grads, cfg = _torch_run(batches, acc, frozen_steps)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    small = None
    for i in range(len(batches)):
        want_g = params_from_jax(j_grads[i], cfg)
        if frozen_steps is None:  # the freeze schedule zeroes .grad in place
            for name, g in want_g.items():
                np.testing.assert_allclose(t_grads[i][name].numpy(), g.numpy(), rtol=GRAD_RTOL,
                                           atol=GRAD_ATOL, err_msg=f"step {i} grad {name}")
        step_small = {n: g.abs() < SMALL_GRAD for n, g in want_g.items()}
        small = step_small if small is None else {n: small[n] | step_small[n] for n in small}
        want_p = params_from_jax(j_params[i], cfg)
        for name, p in want_p.items():
            limit = torch.where(small[name], 2 * MAX_LR * (i + 1) + PARAM_ATOL, PARAM_ATOL)
            err = (t_params[i][name] - p).abs()
            assert torch.all(err <= limit), f"step {i} param {name}: max err {err.max().item()}"
    return t_params


def test_one_step_matches_jax():
    _compare([_batch(1)])


def test_accumulated_step_matches_jax():
    """accumulate_steps=2 (tests/test_grad_accumulation.py:142): two
    microbatches of 2, their gradients averaged."""
    _compare([_batch(1)], acc=2)


def test_freeze_schedule_matches_jax():
    """The backbone frozen for the first of two steps: it does not move in
    step 1, and both packages agree after step 2."""
    _, params, _ = _jax_init()
    t_params = _compare([_batch(1), _batch(2)], frozen_steps=1)
    cfg = ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY), stat_pooling_type="mean")
    init = params_from_jax(params, cfg)
    for name, p in t_params[0].items():
        assert torch.equal(p, init[name]) == name.startswith("wav2vec2"), name
        assert not torch.equal(t_params[1][name], init[name]), name  # released in step 2


def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    task = ttask.SpeakerTask(model, "ce")
    loss, _ = task.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def test_padded_batch_gradients_equal_the_unpadded_rows():
    """The loss is the mean over rows, so the gradients of a padded batch
    are the mean of each row's gradients computed alone, unpadded."""
    _, params, _ = _jax_init()
    model, _ = _torch_model(params)
    batch = _batch(3)
    padded = _grads(model, batch)
    alone = [
        _grads(model, {"features": batch["features"][i : i + 1, :n],
                       "mask": batch["mask"][i : i + 1, :n], "labels": batch["labels"][i : i + 1]})
        for i, n in enumerate(LENGTHS)
    ]
    for name, g in padded.items():
        want = sum(a[name] for a in alone) / len(alone)
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-6, msg=name)


def _regularised_model(seed=0, **over):
    cfg = ts.Wav2Vec2SpeakerConfig(
        w2v2=tw.Wav2Vec2Config(**{**TINY, "layerdrop": 0.5, "mask_time_prob": 0.3,
                                  "mask_time_length": 3, "hidden_dropout": 0.1,
                                  "attention_dropout": 0.1, "feat_proj_dropout": 0.1,
                                  "activation_dropout": 0.1, "num_layers": 4, **over}),
        stat_pooling_type="mean",
    )
    model = ts.Wav2Vec2SpeakerModel(cfg, num_speakers=N_SPK)
    tw.init_parameters(model, torch.Generator().manual_seed(seed))
    return model


def test_training_draws_come_from_the_step_generator():
    """Same generator seed, same regularised step; another seed, another
    one. A dropped layer gets zero gradients and Adam's count stays shared."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    runs = {}
    for seed in (5, 5, 6):
        model = _regularised_model()
        state = tstate.TrainState.create(model, tstate.AdamTx(lambda s: 1e-3), seed=seed)
        step = tsteps.make_train_step(ttask.SpeakerTask(model, "ce"), steps_per_dispatch=3)
        stacked = {k: torch.stack([v] * 3) for k, v in batch.items()}
        state, metrics = step(state, stacked)
        runs.setdefault(seed, []).append((metrics, state))
    (m1, s1), (m2, s2) = runs[5]
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=0, atol=0)
    assert not torch.equal(m1["loss"], runs[6][0][0]["loss"])
    assert m1["loss"].shape == (3,) and torch.isfinite(m1["loss"]).all()
    assert m1["layers_run"].tolist() != [4, 4, 4] or runs[6][0][0]["layers_run"].tolist() != [4, 4, 4]
    steps = {int(st["step"]) for st in s1.tx.adam.state.values()}
    assert steps == {3} and s1.step == 3


def test_train_forward_needs_the_generator_and_eval_ignores_rates():
    model = _regularised_model()
    wav = torch.from_numpy(_batch(0)["features"])
    with pytest.raises(ValueError, match="Generator"):
        model(wav, train=True)
    with torch.no_grad():
        a, b = model(wav)["embedding"], model(wav, train=False, generator=torch.Generator())["embedding"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_steps_per_dispatch_and_embeddings():
    """K stacked steps equal K single steps; return_embeddings adds the
    [B, D] float32 embeddings, also under accumulation."""
    batches = [{k: torch.from_numpy(v) for k, v in _batch(s).items()} for s in (1, 2)]
    finals = []
    for k in (1, 2):
        model = _regularised_model()
        state = tstate.TrainState.create(model, tstate.AdamTx(lambda s: 1e-3), seed=9)
        step = tsteps.make_train_step(ttask.SpeakerTask(model, "ce"), steps_per_dispatch=k,
                                      return_embeddings=True, accumulate_steps=2)
        if k == 1:
            for b in batches:
                state, metrics = step(state, b)
                assert metrics["_embedding"].shape == (4, 32)
        else:
            state, metrics = step(state, {n: torch.stack([b[n] for b in batches]) for n in batches[0]})
            assert metrics["_embedding"].shape == (2, 4, 32)
        finals.append(model.state_dict())
    for name, p in finals[0].items():
        torch.testing.assert_close(finals[1][name], p, rtol=0, atol=0, msg=name)


def test_unported_modes_and_options_raise():
    model = _regularised_model()
    assert ttask.SpeakerTask(model, "aam").mode == "aam"  # ported with the AAM head
    for mode in ("triplet", "triplet_ce"):  # ported with the triplet slice
        assert ttask.SpeakerTask(model, mode).mode == mode
    int8 = ts.Wav2Vec2SpeakerModel(ts.Wav2Vec2SpeakerConfig(w2v2=tw.Wav2Vec2Config(**TINY, int8_matmuls=True)),
                                   num_speakers=N_SPK)
    state = tstate.TrainState.create(int8, tstate.AdamTx(lambda s: 1e-3), seed=0)
    with pytest.raises(RuntimeError, match="inference only"):  # int8 serves; a training step is refused
        tsteps.make_train_step(ttask.SpeakerTask(int8, "ce"))(
            state, {k: torch.from_numpy(v) for k, v in _batch(4).items()})
    with pytest.raises(ValueError, match="unknown training mode"):
        ttask.SpeakerTask(model, "hinge")
    base = texp.load_recipe("speaker_wav2vec2_ce")
    texp._check_ported({**base, "network": {**base["network"], "use_transformers_as_ensembles": True}})
    texp._check_ported({**base, "callbacks": {"progress_tracker": {"every_n_steps": 1}}})  # ported since
    for section, update, kind in (("algo", {"name": "sgd"}, tstate.SgdTx), ("algo", {"mu_dtype": "bfloat16"}, None),
                                  ("algo", {"weight_decay": 0.01}, None),
                                  ("schedule", {"name": "exp_decay", "final_lr": 1e-6}, None)):
        cfg = {**base, "optim": {**base["optim"], section: {**base["optim"][section], **update}}}
        assert isinstance(texp.build_optimizer(cfg), kind or tstate.AdamTx)  # ported since
    for section, key, value in (("algo", "name", "lamb"), ("schedule", "name", "cosine"),
                                ("algo", "mu_dtype", "bf17")):
        cfg = {**base, "optim": {**base["optim"], section: {**base["optim"][section], key: value}}}
        with pytest.raises(ValueError):
            texp.build_optimizer(cfg)


def test_build_optimizer_clips_and_freezes():
    base = texp.load_recipe("speaker_wav2vec2_ce")
    tx = texp.build_optimizer(base)
    assert isinstance(tx, tstate.AdamTx) and tx.schedule(30000) == pytest.approx(9e-5)
    cfg = {**base, "trainer": {**base["trainer"], "gradient_clip_val": 0.5},
           "network": {**base["network"], "wav2vec_initially_frozen": True, "num_frozen_steps": 2,
                       "completely_freeze_feature_extractor": True}}
    tx = texp.build_optimizer(cfg)
    model = _regularised_model()
    state = tstate.TrainState.create(model, tx, seed=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith("wav2vec2"), n
    norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    assert norm.item() == pytest.approx(0.5, rel=1e-5)  # clipped after the frozen grads were zeroed


def test_recipe_config_matches_the_yaml_files():
    def load(*parts):
        return yaml.safe_load((ROOT / "config" / pathlib.Path(*parts)).read_text())

    recipe = texp.load_recipe("speaker_wav2vec2_ce")
    exp = load("experiment", "speaker_wav2vec2_ce.yaml")
    net = load("network", "wav2vec2_fc.yaml")
    assert recipe["network"] == {**net, **exp.get("network", {})}
    algo = {**load("optim", "algo", "adam.yaml"), **exp["optim"]["algo"]}
    assert recipe["optim"]["algo"] == algo
    sched = load("optim", "schedule", "one_cycle.yaml")
    assert recipe["optim"]["schedule"] == sched
    assert recipe["optim"]["loss"] == load("optim", "loss", "cross_entropy.yaml")
    trainer = {**load("trainer", "trainer.yaml"), **exp["trainer"]}
    for key in ("max_steps", "precision", "accumulate_grad_batches", "gradient_clip_val",
                "steps_per_dispatch", "remat"):
        assert recipe["trainer"][key] == trainer[key], key
    assert recipe["data"]["dataloader"]["batch_size"] == exp["data"]["dataloader"]["batch_size"] == 66
