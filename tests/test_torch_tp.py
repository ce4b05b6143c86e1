"""``entry.dryrun_multichip`` (the twin of ``__graft_entry__.dryrun_multichip``)
on 4 spawned gloo ranks, dp=2 x tp=2, from the JAX package's initial
weights of the same tiny model, converted: its steps (``accumulate_steps=2``,
the backbone frozen for the first and released for the second, the
default dropout, layerdrop and span masks, drawn at global row and head
coordinates) equal the 1-process steps on the same 8-row batch (losses
within 1e-5 relative, the post-restore step's too; the released step's
gradients, gathered from the TP shards, within rtol 5e-4 and atol 5e-5 x
the tensor's largest magnitude, at least 1, as the data-parallel tests),
the sharded eval and the checkpoint round trip onto dp=2 run, and the TP
shards gather back to the converted weights exactly. Group timeout 60 s,
deadline 180 s."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2v2_speaker_tpu.models import wav2vec2 as jw
from w2v2_speaker_tpu.models import wav2vec2_speaker as js
from w2v2_speaker_tpu_torch.entry import DRYRUN_TINY, dryrun_multichip
from w2v2_speaker_tpu_torch.models.convert import params_from_jax
from w2v2_speaker_tpu_torch.parallel import tp
from w2v2_speaker_tpu_torch.parallel import mesh as pmesh

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-4, 5e-5
ROWS = 8


@pytest.fixture(scope="module")
def converted():
    cfg = js.Wav2Vec2SpeakerConfig(w2v2=jw.Wav2Vec2Config(**{
        k: getattr(DRYRUN_TINY, k) for k in ("conv_dim", "conv_kernel", "conv_stride", "hidden_size", "num_layers",
                                             "num_heads", "intermediate_size", "num_conv_pos_embeddings",
                                             "num_conv_pos_embedding_groups")}), stat_pooling_type="mean")
    model = js.Wav2Vec2SpeakerModel(cfg=cfg, num_speakers=16)
    x = jnp.zeros((2, 800))
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), x, jnp.ones((2, 800), bool))["params"])
    return params_from_jax(params, types.SimpleNamespace(num_layers=DRYRUN_TINY.num_layers))


@pytest.fixture(scope="module")
def runs(converted):
    before, threads = pmesh.GROUP_TIMEOUT_S, torch.get_num_threads()
    pmesh.GROUP_TIMEOUT_S = 60.0  # the spawned ranks' groups
    torch.set_num_threads(1)
    try:
        four = dryrun_multichip(4, "cpu", rows=ROWS, state_dict=converted, deadline=180)
        one = dryrun_multichip(1, "cpu", rows=ROWS, state_dict=converted)
    finally:
        torch.set_num_threads(threads)
        pmesh.GROUP_TIMEOUT_S = before
    return four, one


def test_dryrun_multichip_runs_dp2_tp2(runs):
    four, _ = runs
    assert four["kind"] == "dp=2 x tp=2" and four["restored_onto"] == 2
    assert four["embeddings"] == (ROWS, DRYRUN_TINY.hidden_size) and four["logits"][0] == ROWS
    assert np.isfinite(four["loss"]) and np.isfinite(four["restored_loss"])


def test_tp_step_matches_one_process(runs):
    four, one = runs
    assert one["kind"] == "dp=1 x tp=1"
    np.testing.assert_allclose(four["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(four["released_loss"], one["released_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(four["restored_loss"], one["restored_loss"], rtol=LOSS_RTOL)


def test_tp_gradients_match_one_process(runs):
    """The released step's gradients on dp=2 x tp=2, the sharded ones
    gathered, equal the 1-process step's: every sharded site's backward
    (the model-group all-reduce of ``copy_to_model``) and the data-group
    reduce feed them."""
    four, one = runs
    assert four["grads"].keys() == one["grads"].keys()
    sharded = [n for n in one["grads"] if any(site in n for site in ("qkv_proj", "intermediate_dense", "out_proj",
                                                                     "output_dense"))]
    assert len(sharded) == 8 * DRYRUN_TINY.num_layers
    live = [n for n in sharded if float(one["grads"][n].abs().max()) > 0]
    assert len(live) >= 8, live  # the backbone released: a kept layer's eight sharded tensors
    for name, g in one["grads"].items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(four["grads"][name].numpy(), g.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=name)


def test_tp_shards_gather_back_to_the_converted_weights(runs, converted):
    four, _ = runs
    assert four["gathered"].keys() == converted.keys()
    for name, want in converted.items():
        assert torch.equal(four["gathered"][name], want), name


def test_tp_rules_cover_the_four_dense_sites():
    rules = dict(tp.wav2vec2_tp_rules())
    assert sorted(rules.values()) == ["column", "qkv", "row", "row"]
    assert tp._qkv_rows(12, 2, 1).tolist() == [2, 3, 6, 7, 10, 11]
