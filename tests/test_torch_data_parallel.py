"""One data-parallel train step of the port on 2 gloo ranks against the
port's 1-process step on the same global batch and against the JAX
package's ``make_train_step`` on a 2-device mesh, float32, tiny widths.

Cases (``tools/torch_parallel_cases.py`` runs them on each rank):

- ``ce_reg``: speaker CE, ``accumulate_steps=2``, dropout, layerdrop and
  SpecAugment time masks on: the ranks draw the global masks' rows, so
  the 2-rank step equals the 1-process step (the JAX package draws its
  masks from its own keys: the cross-package case is ``ce``);
- ``ce``: the same, every rate at 0, also against JAX;
- ``xvector``: the fbank x-vector, whose BatchNorms take the global
  microbatch's statistics; against JAX also the running statistics;
- ``speech``: CTC over a batch padded with an empty-label row to the
  world's row multiple (the padding row leaves the mean);
- ``triplet``: the miner on the all-gathered embeddings with the shared
  generator (the JAX miner draws otherwise: port only).

Limits (PERF.md §2): loss 1e-5 relative, gradients rtol 5e-4 and atol
5e-5 x the tensor's largest magnitude (at least 1); x-vector against JAX at
``tests/test_torch_speaker_families.py``'s step limits (the two packages'
fbanks differ in float32 rounding). After the step every rank's parameters
and buffers are bit-identical. The world is spawned once for the file,
with a 60 s group timeout and a 240 s deadline.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from w2v2_speaker_tpu.data.features import FbankConfig as JaxFbankConfig
from w2v2_speaker_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu.models import wav2vec2_speech as jsp
from w2v2_speaker_tpu.models import xvector as jxv
from w2v2_speaker_tpu.models.frontend import FbankFrontend as JaxFrontend
from w2v2_speaker_tpu.parallel.mesh import create_mesh as jax_mesh
from w2v2_speaker_tpu.parallel.mesh import shard_batch
from w2v2_speaker_tpu.train import state as jstate
from w2v2_speaker_tpu.train import steps as jsteps
from w2v2_speaker_tpu.train.speaker_task import SpeakerTask as JaxSpeakerTask
from w2v2_speaker_tpu.train.speech_task import SpeechTask as JaxSpeechTask
from w2v2_speaker_tpu_torch.data.collate import pad_batch_rows
from w2v2_speaker_tpu_torch.data.tokenizer import CharTokenizer
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.parallel.mesh import spawn

from tools import torch_parallel_cases as cases_mod  # the repository root is on the path: the ranks import it too

TINY = dict(  # __graft_entry__.py:130-140, every rate at 0
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, layerdrop=0.0,
    mask_time_prob=0.0, hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
)
REG = {**TINY, "layerdrop": 0.3, "mask_time_prob": 0.3, "mask_time_length": 4, "hidden_dropout": 0.1,
       "attention_dropout": 0.1, "feat_proj_dropout": 0.1, "activation_dropout": 0.1}
XV = dict(in_channels=40, tdnn_channels=(16, 16, 16, 16, 32), lin_neurons=16)
SPK, N = 8, 1600
VOCAB_TEXTS = ["abc d", "cab", "dd a", "b c", "a"]
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 5e-5
XV_LIMITS = {"loss": 5e-4, "grads": 3e-2, "stats": 5e-4}  # tests/test_torch_speaker_families.py
WORLD, DEADLINE, GROUP_TIMEOUT = 2, 240.0, 60.0
LAYERS = types.SimpleNamespace(num_layers=TINY["num_layers"])  # read by params_from_jax


def _wavs(rows, n=N, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(n // 2, n + 1, rows)
    lengths[0] = n
    mask = np.arange(n)[None, :] < lengths[:, None]
    return (rng.normal(0, 0.5, (rows, n)).astype(np.float32) * mask), mask


def _speaker_batch(rows, labels, seed=0):
    wav, mask = _wavs(rows, seed=seed)
    return {"features": wav, "mask": mask, "labels": np.asarray(labels, np.int32)}


def _speech_batch(tok):
    """5 utterances padded to 6 rows (the world's multiple): the sixth row
    is all-invalid with an empty label, as the run loop pads."""
    wav, mask = _wavs(5, seed=3)
    ids = [tok.encode(t) for t in VOCAB_TEXTS]
    labels = np.zeros((5, 8), np.int32)
    for i, x in enumerate(ids):
        labels[i, : len(x)] = x
    batch = {"features": wav, "mask": mask, "labels": labels,
             "label_lengths": np.array([len(x) for x in ids], np.int32)}
    return pad_batch_rows(batch, 6)


@functools.lru_cache(maxsize=None)
def jax_models():
    """(JAX model, task, params, model_state, port case) of every case."""
    out = {}
    tok = CharTokenizer.build(VOCAB_TEXTS)
    for name in ("ce_reg", "ce", "triplet"):
        w2v2 = REG if name == "ce_reg" else TINY
        jmodel = js.Wav2Vec2SpeakerModel(cfg=js.Wav2Vec2SpeakerConfig(
            w2v2=jw.Wav2Vec2Config(**w2v2), stat_pooling_type="mean"), num_speakers=SPK)
        labels = [0, 0, 1, 1, 2, 2, 3, 3] if name == "triplet" else [0, 3, 5, 1, 7, 2, 2, 6]
        batch = _speaker_batch(8, labels, seed=1)
        mode = "triplet" if name == "triplet" else "ce"
        params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batch["features"]),
                                                      jnp.asarray(batch["mask"]))["params"])
        case = {"kind": "speaker", "w2v2": w2v2, "config": {"stat_pooling_type": "mean"}, "speakers": SPK,
                "mode": mode, "acc": 2 if name.startswith("ce") else 1, "batch": batch, "seed": 5,
                "state_dict": params_from_jax(params, LAYERS)}
        out[name] = (jmodel, JaxSpeakerTask(model=jmodel, mode=mode), params, {}, case)
    jmodel = JaxFrontend(jxv.XVectorModel(jxv.XVectorConfig(**XV), SPK), fbank=JaxFbankConfig(n_mels=40))
    wav, mask = _wavs(4, n=8000, seed=2)
    batch = {"features": wav, "mask": mask, "labels": np.array([1, 4, 1, 6], np.int32)}
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask)))
    case = {"kind": "xvector", "config": XV, "speakers": SPK, "batch": batch, "acc": 1, "seed": 5,
            "state_dict": params_from_jax(v["params"], None, v["batch_stats"])}
    out["xvector"] = (jmodel, JaxSpeakerTask(model=jmodel, mode="ce"), v["params"],
                      {"batch_stats": v["batch_stats"]}, case)
    jcfg = jsp.Wav2Vec2SpeechConfig(w2v2=jw.Wav2Vec2Config(**TINY), vocab_size=tok.vocab_size, head_dropout=0.0)
    jmodel = jsp.Wav2Vec2SpeechModel(cfg=jcfg)
    batch = _speech_batch(tok)
    params = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batch["features"]),
                                                  jnp.asarray(batch["mask"]))["params"])
    case = {"kind": "speech", "w2v2": TINY, "config": {"vocab_size": tok.vocab_size, "head_dropout": 0.0},
            "vocab": tok.vocab, "batch": batch, "acc": 1, "seed": 5, "state_dict": params_from_jax(params, LAYERS)}
    out["speech"] = (jmodel, JaxSpeechTask(model=jmodel, tokenizer=JaxTokenizer(tok.vocab)), params, {}, case)
    return out


CASES = ("ce_reg", "ce", "xvector", "speech", "triplet")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def results(one_thread):
    """Every case on 2 spawned ranks (rank 0's results) and in this process."""
    cases = [jax_models()[name][4] for name in CASES]
    ranks = spawn(cases_mod.rank_cases, (cases,), nprocs=WORLD, deadline=DEADLINE, timeout=GROUP_TIMEOUT, threads=1)
    return {name: (got, cases_mod.step_case(case)) for name, got, case in zip(CASES, ranks, cases)}


def _close_grads(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    assert got.keys() == want.keys()
    for name, g in want.items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=rtol, atol=atol * scale, err_msg=name)


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_one_process(results, name):
    """Loss, gradients and the updated state of the 2-rank step equal the
    1-process step's; every rank holds the same parameters and buffers."""
    got, want = results[name]
    assert got["replicas_equal"]
    assert got["layers_run"] == want["layers_run"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    _close_grads(got["grads"], want["grads"])
    for k, v in want["state"].items():  # Adam's first step moves a weight by ~lr; the buffers equal
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=0, atol=2e-3 if v.is_floating_point() else 0,
                                   err_msg=k)
    if name == "ce_reg":  # the masks and layerdrop did act: the step differs from the rates-0 one
        assert abs(got["loss"] - results["ce"][0]["loss"]) > 1e-4


def test_ranks_step_in_full_float32(results):
    """A spawned rank is a fresh process, whose PyTorch defaults run cuDNN's
    float32 convolutions in TF32; each rank's step sets full float32 first,
    as the port's entry points do for the card (a float32 2-rank step on
    the card once read 9.55e-4 from one rank at the first conv's weight
    gradient: TF32 in the ranks only). Rank 0's step reports both TF32
    flags off, as this process's does."""
    for name in CASES:
        got, want = results[name]
        assert got["tf32"] == want["tf32"] == (False, False), name


@pytest.mark.parametrize("name", ["ce", "xvector", "speech"])
def test_two_ranks_match_jax_two_devices(results, name):
    """The JAX package's ``make_train_step`` on a 2-device mesh: its loss
    and the batch's gradient (``jax.grad``, the same function at every
    rate 0) against the 2-rank step; the x-vector's running statistics."""
    jmodel, jtask, params, model_state, case = jax_models()[name]
    got, _ = results[name]
    batch = jax.tree.map(jnp.asarray, case["batch"])
    mesh = jax_mesh(jax.devices()[:WORLD])
    grads = jax.jit(jax.grad(lambda p: jtask.loss_fn(p, model_state, batch, jax.random.PRNGKey(2), train=True)[0]))(
        jax.tree.map(jnp.asarray, params))  # before the step, which donates its inputs
    want = params_from_jax(jax.device_get(grads), LAYERS)
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
                                     tx=optax.adam(1e-3), model_state=model_state, rng=jax.random.PRNGKey(1))
    new_state, metrics = jsteps.make_train_step(jtask, mesh, accumulate_steps=case["acc"])(
        state, shard_batch(case["batch"], mesh))
    stats = jax.device_get(new_state.model_state).get("batch_stats")
    if name == "xvector":
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=XV_LIMITS["loss"])
        for k, g in want.items():
            err = float((got["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-3)
            assert err < XV_LIMITS["grads"], k
        for k, v in params_from_jax(jax.device_get(new_state.params), LAYERS, stats).items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=XV_LIMITS["stats"],
                                           atol=XV_LIMITS["stats"], err_msg=k)
        return
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
    _close_grads(got["grads"], want)
