"""The port's ``CheckpointManager`` and ``resolve_checkpoint_path``
(``train/checkpoint.py``) against the JAX package's: the same best-k
choices, directory names and ``index.json`` for one metric sequence, the
same resume epoch, the same ``average_best`` of the same weights (float32,
exact to 1 ulp), and a restore that brings back the model, Adam's moments
and counts, and the step generator's stream."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from w2v2_speaker_tpu.train import checkpoint as jckpt
from w2v2_speaker_tpu.train.state import TrainState as JaxState
from w2v2_speaker_tpu_torch.objectives import schedules
from w2v2_speaker_tpu_torch.train import checkpoint as tckpt
from w2v2_speaker_tpu_torch.train.state import AdamTx, ClipTx, TrainState, make_freeze_schedule_tx

# (step, epoch, val_eer): a second validation at step 40 (an epoch cap on a
# validation boundary), a NaN, and ties
SEQUENCE = [(10, 0, 0.30), (20, 0, 0.20), (30, 1, 0.25), (40, 1, 0.10), (40, 2, 0.10), (50, 2, float("nan")),
            (60, 3, 0.20), (70, 3, 0.05)]


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(3, 4))
        self.register_buffer("count", torch.zeros((), dtype=torch.int64))


def _weights(step):
    return np.random.default_rng(step).normal(size=(3, 4)).astype(np.float32)


def _torch_state():
    model = Toy()
    tx = ClipTx(AdamTx(schedules.one_cycle(1e-2, 100, 0.3, 25.0, 1e4)), 1.0)
    tx = make_freeze_schedule_tx(tx, lambda p: p == "w", num_frozen_steps=3)
    return TrainState.create(model, tx, seed=4)


def _run(tmp_path, top_k):
    """Both managers through ``SEQUENCE``, the weights at each step those of
    ``_weights(step)``; returns (jax manager, torch manager, jax template,
    torch state)."""
    jstate = JaxState.create(apply_fn=None, params={"w": jnp.zeros((3, 4))}, tx=optax.adam(1e-3),
                             rng=jax.random.PRNGKey(0))
    tstate = _torch_state()
    jm = jckpt.CheckpointManager(tmp_path / "jax", top_k=top_k)
    tm = tckpt.CheckpointManager(tmp_path / "torch", top_k=top_k)
    for step, epoch, eer in SEQUENCE:
        jstate = jstate.replace(step=jnp.asarray(step, jnp.int32), params={"w": jnp.asarray(_weights(step))})
        with torch.no_grad():
            tstate.model.w.copy_(torch.from_numpy(_weights(step)))
        tstate.step = step
        jm.save_step(jstate, {"val_eer": eer, "val_mdc": 0.5}, epoch=epoch)
        tm.save_step(tstate, {"val_eer": eer, "val_mdc": 0.5}, epoch=epoch)
    return jm, tm, jstate, tstate


@pytest.mark.parametrize("top_k", [1, 3])
def test_best_k_index_and_resume_epoch_match_jax(tmp_path, top_k):
    jm, tm, _, _ = _run(tmp_path, top_k)
    index = json.loads((tmp_path / "torch" / "index.json").read_text())
    assert index == json.loads((tmp_path / "jax" / "index.json").read_text())
    assert index["last"] == {"step": 70, "epoch": 3}
    assert [e["name"] for e in index["best"]] == [
        "step00000070_val_eer=0.0500", "step00000040_val_eer=0.1000", "step00000020_val_eer=0.2000"][:top_k]
    dirs = sorted(p.name for p in (tmp_path / "torch").iterdir() if p.is_dir())
    assert dirs == sorted(p.name for p in (tmp_path / "jax").iterdir() if p.is_dir())
    assert dirs == sorted(["last", *[e["name"] for e in index["best"]]])
    assert tm.last_epoch() == jm.last_epoch() == 3
    assert tm.best_path.name == jm.best_path.name
    reopened = tckpt.CheckpointManager(tmp_path / "torch", top_k=top_k)
    assert reopened.last_epoch() == 3 and reopened.best_path == tm.best_path


def test_average_best_matches_jax(tmp_path):
    """The mean of the best 3 checkpoints' weights, as the JAX package
    averages them; the integer buffer and the step come from the best."""
    jm, tm, jstate, tstate = _run(tmp_path, 3)
    want = np.asarray(jm.average_best(jstate, 3).params["w"])
    got = tm.average_best(tstate, 3)
    np.testing.assert_allclose(got.model.w.detach().numpy(), want, rtol=1e-7, atol=0)
    np.testing.assert_allclose(want, np.mean([_weights(s) for s in (70, 40, 20)], axis=0), rtol=1e-6)
    assert got.step == 70 and got.model.count.dtype == torch.int64
    single = tm.average_best(_torch_state(), 1)  # fewer than 2: the best alone
    np.testing.assert_array_equal(single.model.w.detach().numpy(), _weights(70))


def test_resolve_checkpoint_path_matches_jax(tmp_path):
    _run(tmp_path, 2)
    for name in ("jax", "torch"):
        assert tckpt.resolve_checkpoint_path(tmp_path / name / "best") == jckpt.resolve_checkpoint_path(
            tmp_path / name / "best") == tmp_path / name / "step00000070_val_eer=0.0500"
    empty = tmp_path / "no_best"
    empty.mkdir()
    (empty / "index.json").write_text(json.dumps({"best": [], "last": {"step": 3}}))
    (empty / "last").mkdir()
    for path in (empty / "best", tmp_path / "missing" / "best", tmp_path / "torch" / "last"):
        assert tckpt.resolve_checkpoint_path(path) == jckpt.resolve_checkpoint_path(path)
    assert tckpt.resolve_checkpoint_path(empty / "best") == empty / "last"


def test_restore_brings_back_moments_counts_and_the_generator(tmp_path):
    """A state saved after 5 updates and restored into a fresh one takes
    the same next update and draws the same next random numbers as the
    state that went on; ``load_params`` reads a checkpoint directory."""
    state = _torch_state()
    for _ in range(5):
        state.model.w.grad = torch.randn(3, 4, generator=state.generator)
        state.apply_gradients()
    manager = tckpt.CheckpointManager(tmp_path, top_k=1)
    manager.save_step(state, {"val_eer": 0.3}, epoch=1)
    fresh = manager.restore(_torch_state(), name="last")
    assert fresh.step == state.step == 5 and fresh.tx.count == state.tx.count == 5
    for s in (state, fresh):
        s.model.w.grad = torch.randn(3, 4, generator=s.generator)
        s.apply_gradients()
    assert torch.equal(fresh.model.w, state.model.w) and torch.equal(fresh.generator.get_state(),
                                                                     state.generator.get_state())
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(tmp_path / "empty").restore(_torch_state(), name="last")
    target = Toy()
    tckpt.load_params(tmp_path / "best", target)
    np.testing.assert_array_equal(target.w.detach().numpy(), manager.restore(_torch_state()).model.w.detach().numpy())
