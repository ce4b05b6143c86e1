"""The port's learning-rate schedules and optimizers against the JAX
package's on the CPU:

- the rate of each schedule added beside one-cycle and tri-stage (whose
  tests are ``tests/test_torch_objectives.py`` and
  ``tests/test_torch_speech.py``) over 60 steps, by name through
  ``get_schedule``: constant, step, multi-step, exp_decay, cyclic with and
  without ``step_size_down``, within 1e-6 relative (the JAX package
  computes in float32, the port in float64);
- the reduce-on-plateau controller's factors over one metric sequence,
  exactly, and its state carried through ``state_dict``;
- five updates of a small parameter tree (a ``wav2vec2`` subtree frozen for
  the first two, gradients of global norm ~7 clipped to 1) by
  ``build_optimizer`` of both packages: SGD with momentum, SGD with weight
  decay, AdamW, Adam and AdamW with the first moment in bfloat16, and
  reduce-on-plateau with its factor moved after the second update. The
  parameters within 1e-6 (float32, the same rule in another order of
  roundings: the readings are ~2e-7), the bfloat16 moment within one
  bfloat16 rounding (1/128 relative; it reads 0) and stored as bfloat16;
- ``build_optimizer`` on every preset of ``config/optim/algo`` x
  ``config/optim/schedule``: three updates within 1e-6;
- a bfloat16-moment AdamW state saved and loaded mid-run resumes to the
  same parameters, its moment still bfloat16.
"""

import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from w2v2_speaker_tpu.objectives import schedules as jsched
from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch.objectives import schedules as tsched
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train.state import TrainState, find_schedule

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "config"
PARAM_ATOL = 1e-6
BF16_REL = 2.0 ** -7  # one bfloat16 rounding step, relative
SCHEDULES = [
    ("constant", dict(lr=3e-4)),
    ("step", dict(lr=1e-3, step_size=7, gamma=0.5)),
    ("multi_step", dict(lr=1e-3, milestones=[5, 20], gamma=0.1)),
    ("exp_decay", dict(max_steps=40, base_lr=1e-3, final_lr=1e-6)),
    ("cyclic", dict(base_lr=1e-5, max_lr=5e-3, step_size_up=6, step_size_down=7)),
    ("cyclic", dict(base_lr=1e-4, max_lr=1e-3, step_size_up=5)),
]
ADAM = {"name": "adam", "lr": 1e-2, "b1": 0.9, "b2": 0.999}
CASES = {
    "sgd": ({"name": "sgd", "lr": 1e-2, "momentum": 0.9}, {"name": "constant"}),
    "sgd_weight_decay": ({"name": "sgd", "lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-2},
                         {"name": "cyclic", "base_lr": 1e-3, "max_lr": 1e-2, "step_size_up": 2}),
    "adamw": ({**ADAM, "weight_decay": 1e-2}, {"name": "exp_decay", "final_lr": 1e-4}),
    "adam_bf16_mu": ({**ADAM, "mu_dtype": "bfloat16"},
                     {"name": "one_cycle", "pct_start": 0.3, "div_factor": 25.0, "final_div_factor": 1e4}),
    "adamw_bf16_mu_plateau": ({**ADAM, "weight_decay": 1e-2, "mu_dtype": "bfloat16"},
                              {"name": "reduce_on_plateau", "factor": 0.1, "patience": 0}),
}


@pytest.mark.parametrize("name, kwargs", SCHEDULES, ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_rates_match_jax(name, kwargs):
    want = [float(jsched.get_schedule(name, **kwargs)(s)) for s in range(60)]
    got = [tsched.get_schedule(name, **kwargs)(s) for s in range(60)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert len(set(got)) > (1 if name != "constant" else 0)


def test_plateau_controller_matches_jax():
    metrics = [0.5, 0.4, 0.4, 0.45, 0.41, 0.3, 0.3, 0.3, 0.31, 0.2, 0.2, 0.2, 0.2, 0.25, 0.1]
    for kw in (dict(factor=0.1, patience=0), dict(factor=0.5, patience=2), dict(factor=0.1, patience=1, mode="max"),
               dict(factor=1e-3, patience=0, min_factor=1e-7)):
        got, want = tsched.ReduceLROnPlateauController(**kw), jsched.ReduceLROnPlateauController(**kw)
        factors = [got.update(m) for m in metrics]
        assert factors == [want.update(m) for m in metrics] and len(set(factors)) > 1
    got = tsched.ReduceLROnPlateauController(factor=0.5, patience=1)
    for m in metrics[:6]:
        got.update(m)
    resumed = tsched.ReduceLROnPlateauController(factor=0.5, patience=1)
    resumed.load_state_dict(got.state_dict())
    assert [resumed.update(m) for m in metrics[6:]] == [got.update(m) for m in metrics[6:]]
    rate = tsched.PlateauSchedule(3e-4, resumed)
    assert rate(0) == float(jnp.asarray(3e-4 * resumed.factor_value, jnp.float32))


class Tiny(nn.Module):
    """Parameters named ``wav2vec2/...`` (frozen by the freeze schedule)
    and ``head/...``."""

    def __init__(self):
        super().__init__()
        self.wav2vec2 = nn.Linear(4, 3)
        self.head = nn.Linear(3, 2)


def _tree(rng, scale=1.0):
    return {mod: {"weight": (scale * rng.normal(size=shape)).astype(np.float32),
                  "bias": (scale * rng.normal(size=shape[:1])).astype(np.float32)}
            for mod, shape in (("wav2vec2", (3, 4)), ("head", (2, 3)))}


def _cfg(algo, schedule, max_steps=10, clip=1.0, frozen=2):
    return {"optim": {"algo": dict(algo), "schedule": dict(schedule)},
            "trainer": {"max_steps": max_steps, "gradient_clip_val": clip},
            "network": {"wav2vec_initially_frozen": frozen is not None, "num_frozen_steps": frozen}}


def _port_state(cfg, params):
    model = Tiny()
    model.load_state_dict({f"{m}.{k}": torch.from_numpy(v) for m, sub in params.items() for k, v in sub.items()})
    return TrainState.create(model, texp.build_optimizer(cfg))


def _port_step(state, grads):
    for name, p in state.model.named_parameters():
        mod, key = name.split(".")
        p.grad = torch.from_numpy(grads[mod][key].copy())
    state.apply_gradients()


def _port_params(state):
    return {n.replace(".", "/"): p.detach().numpy().copy() for n, p in state.model.named_parameters()}


def _jax_flat(tree):
    return {f"{m}/{k}": np.asarray(v) for m, sub in tree.items() for k, v in sub.items()}


def run_both(cfg, steps=5, seed=0, plateau_at=None, resume_at=None):
    """``steps`` updates of both packages' ``build_optimizer(cfg)`` from
    the same parameters and gradients: (port params per step, JAX params
    per step, port state, JAX optimizer state). ``plateau_at``: after that
    many updates the rate is scaled by 0.1 (the controller's factor in the
    port, the injected hyperparameter in the JAX package). ``resume_at``:
    after that many updates the port's state is saved and loaded into a
    fresh one."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(steps)]
    jtx = jexp.build_optimizer(cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jparams)
    state = _port_state(cfg, params)
    got, want = [], []
    for i, g in enumerate(grads):
        if i == plateau_at:
            lr = cfg["optim"]["algo"]["lr"] * 0.1
            jstate = optax.tree_utils.tree_set(jstate, learning_rate=jnp.asarray(lr, jnp.float32))
            find_schedule(state.tx).controller.factor_value = 0.1
        if i == resume_at:
            buf = io.BytesIO()
            torch.save(state.state_dict(), buf)
            fresh = _port_state(cfg, _tree(np.random.default_rng(99)))
            buf.seek(0)
            fresh.load_state_dict(torch.load(buf, weights_only=True))
            state = fresh
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _port_step(state, g)
        want.append(_jax_flat(jparams))
        got.append(_port_params(state))
    return got, want, state, jstate


def _assert_params_close(got, want):
    for step, (g, w) in enumerate(zip(got, want, strict=True)):
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=PARAM_ATOL, err_msg=f"update {step + 1} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_updates_match_optax(case):
    algo, schedule = CASES[case]
    cfg = _cfg(algo, schedule)
    plateau = schedule["name"] == "reduce_on_plateau"
    got, want, state, jstate = run_both(cfg, plateau_at=2 if plateau else None)
    _assert_params_close(got, want)
    initial = _tree(np.random.default_rng(0))
    for step in (0, 1):  # frozen for the first two updates in both, weight decay or not
        np.testing.assert_array_equal(got[step]["wav2vec2/weight"], initial["wav2vec2"]["weight"])
    assert np.abs(got[-1]["wav2vec2/weight"] - initial["wav2vec2"]["weight"]).max() > 1e-4
    if algo.get("mu_dtype"):
        mu = optax.tree_utils.tree_get(jstate, "mu")
        tx = state.tx
        while not hasattr(tx, "mu"):
            tx = tx.inner
        names = [n for n, _ in state.named_params()]
        for name, m in zip(names, tx.mu, strict=True):
            ref = np.asarray(mu[name.split("/")[0]][name.split("/")[1]].astype(jnp.float32))
            assert m.dtype == torch.bfloat16 and mu[name.split("/")[0]][name.split("/")[1]].dtype == jnp.bfloat16
            np.testing.assert_allclose(m.float().numpy(), ref, rtol=BF16_REL, atol=0, err_msg=name)


ALGOS = sorted(p.stem for p in (CONFIG / "optim" / "algo").glob("*.yaml"))
SCHEDS = sorted(p.stem for p in (CONFIG / "optim" / "schedule").glob("*.yaml"))


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("algo", ALGOS)
def test_every_preset_updates_as_jax(algo, sched):
    cfg = texp.load_recipe("speaker_wav2vec2_ce", [
        f"optim/algo={algo}", f"optim/schedule={sched}", "optim.algo.lr=1e-2", "trainer.max_steps=10",
        "network.wav2vec_initially_frozen=true", "network.num_frozen_steps=1"])
    got, want, _, _ = run_both(cfg, steps=3, seed=1)
    _assert_params_close(got, want)
    assert np.abs(got[-1]["head/weight"] - _tree(np.random.default_rng(1))["head"]["weight"]).max() > 0


def test_bf16_moment_state_resumes():
    algo, schedule = CASES["adamw_bf16_mu_plateau"]
    cfg = _cfg(algo, schedule)
    got, want, state, _ = run_both(cfg, steps=5, plateau_at=1, resume_at=3)
    _assert_params_close(got, want)
    tx = state.tx
    while not hasattr(tx, "mu"):
        tx = tx.inner
    assert all(m.dtype == torch.bfloat16 for m in tx.mu) and tx.count == 5
    assert find_schedule(state.tx).controller.factor_value == 0.1
