"""Recipe assembly of the port against the JAX package's: the backbone
config of a network dict (every key ``_w2v2_config`` reads, with its
defaults), the speaker and paired model configs and modes of
``build_model_and_task``, and the LARGE AAM recipe, composed from ``config/`` by the port's
``load_config``, against the YAML files."""

import dataclasses
import pathlib

import pytest
import torch
import yaml

from w2v2_speaker_tpu.runtime import experiment as jexp
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.train.paired_task import PairedSpeakerTask
from w2v2_speaker_tpu_torch.train.speaker_task import SpeakerTask

ROOT = pathlib.Path(__file__).resolve().parents[1]
CE, LARGE = texp.load_recipe("speaker_wav2vec2_ce"), texp.load_recipe("speaker_wav2vec2_large_aam")
_REGULARISATION = {k: CE["network"][k] for k in (
    "activation_dropout", "attention_dropout", "feat_proj_dropout", "hidden_dropout", "layerdrop",
    "mask_feature_length", "mask_feature_prob", "mask_time_length", "mask_time_prob")}
NETWORKS = {
    "ce_recipe": CE["network"],
    "large_aam_recipe": LARGE["network"],
    "fused_conv": {**LARGE["network"], "conv_impl": "fused_pallas", "posconv_decomposed": True},
    "defaults_only": dict(_REGULARISATION),  # every optional key at its default
    "tiny_int8_yaml_one": {**_REGULARISATION, "wav2vec2_size": "tiny", "int8_matmuls": 1,
                           "attention_impl": "flash", "encoder_unroll": 4, "hash_dropout": False},
    "int8_auto": {**CE["network"], "int8_matmuls": "auto", "remat_policy": "dots"},
}


@pytest.mark.parametrize("remat, accumulate", [(False, 1), (True, 2)])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_w2v2_config_matches_jax(net, precision, remat, accumulate):
    want = jexp._w2v2_config(NETWORKS[net], precision, remat, accumulate)
    got = texp.w2v2_config(NETWORKS[net], precision, remat, accumulate)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_int8_and_unported_networks_raise():
    """``int8_matmuls`` true (YAML's 1 too), which once raised, builds a
    model whose five dense sites per layer and projection are
    ``QuantLinear``s (``auto`` builds full precision). The wav2vec v1
    networks, once unported, are built by ``build_model_and_task``;
    ``speaker_model_config``, the wav2vec2_fc network's config, refuses
    them and the losses that network does not take."""
    from w2v2_speaker_tpu_torch.ops.quant import int8_enabled

    net = NETWORKS["tiny_int8_yaml_one"]
    assert texp.w2v2_config(net, "f32").int8_matmuls is True
    for net, sites in ((net, 1 + 4 * texp.TINY_W2V2.num_layers), (NETWORKS["int8_auto"], 0)):
        with torch.device("meta"):
            task, _ = texp.build_model_and_task({**CE, "network": {**CE["network"], **net}}, 4)
        assert int8_enabled(task.model, True) == sites
    for name in ("wav2vec_fc", "wav2vec_xvector"):
        with pytest.raises(ValueError, match=f"network '{name}' is not wav2vec2_fc"):
            texp.speaker_model_config({**CE, "network": {**CE["network"], "name": name}})
        with torch.device("meta"):
            task, kind = texp.build_model_and_task(texp.load_recipe("speaker_wav2vec2_ce", [f"network={name}"]), 4)
        assert kind == "speaker" and type(task.model).__name__ == type(jexp.build_model_and_task(
            texp.load_recipe("speaker_wav2vec2_ce", [f"network={name}"]), 4)[0].model).__name__
    with pytest.raises(ValueError, match="'ctc_ce' is not a loss of the wav2vec2_fc network"):
        texp.speaker_model_config({**CE, "optim": {**CE["optim"], "loss": {"name": "ctc_ce"}}})
    for loss in ("triplet", "triplet_ce"):  # ported with the triplet slice
        assert texp.speaker_model_config({**CE, "optim": {**CE["optim"], "loss": {"name": loss}}})[1] == loss


@pytest.mark.parametrize("recipe", ["ce", "large_aam"])
def test_speaker_model_config_matches_jax_build_model_and_task(recipe):
    cfg = {"ce": CE, "large_aam": LARGE}[recipe]
    want_task, kind = jexp.build_model_and_task(cfg, num_speakers=5994)
    got_cfg, mode = texp.speaker_model_config(cfg)
    assert kind == "speaker" and mode == want_task.mode == {"ce": "ce", "large_aam": "aam"}[recipe]
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_task.model.cfg)
    assert want_task.model.num_speakers == 5994


@pytest.mark.parametrize("constants", [(), ("network.cls_token_constant=0.5", "network.sep_token_constant=-3.0")],
                         ids=["recipe", "constants"])
def test_paired_model_config_matches_jax_build_model_and_task(constants):
    """``wav2vec2_paired`` builds ``(PairedSpeakerTask, "paired")`` with the
    JAX package's config, CLS and SEP constants from the network config;
    the model's submodules are the flax tree's top level."""
    cfg = texp.load_recipe("speaker_wav2vec2_pairs", list(constants))
    want_task, want_kind = jexp.build_model_and_task(cfg, num_speakers=5994)
    assert dataclasses.asdict(texp.paired_model_config(cfg)) == dataclasses.asdict(want_task.model.cfg)
    tiny = {**cfg, "network": {**cfg["network"], "wav2vec2_size": "tiny"}}
    task, kind = texp.build_model_and_task(tiny, num_speakers=5994)
    assert kind == want_kind == "paired" and isinstance(task, PairedSpeakerTask)
    assert [n for n, _ in task.model.named_children()] == [
        "feature_encoder", "feature_projection", "encoder", "equality_head"]
    assert task.model.cfg.cls_token_constant == cfg["network"]["cls_token_constant"]


def test_build_model_and_task_builds_the_aam_model():
    cfg = {**LARGE, "network": {**LARGE["network"], "wav2vec2_size": "tiny",
                                "explicit_num_speakers": 7}}
    task, kind = texp.build_model_and_task(cfg, num_speakers=5994)
    assert kind == "speaker" and isinstance(task, SpeakerTask) and task.mode == "aam"
    assert task.model.aam.weights.shape == (7, 48) and task.model.head.fc_out is None
    assert task.model.cfg.w2v2.remat and task.model.cfg.w2v2.remat_policy == "dots_no_batch"
    tw.init_parameters(task.model, torch.Generator().manual_seed(0))
    w = task.model.aam.weights
    assert torch.isfinite(w).all() and w.abs().max() <= 2 * (2 / (7 + 48)) ** 0.5 / 0.8796 + 1e-6


def test_large_aam_recipe_matches_the_yaml_files():
    def load(*parts):
        return yaml.safe_load((ROOT / "config" / pathlib.Path(*parts)).read_text())

    exp = load("experiment", "speaker_wav2vec2_large_aam.yaml")
    net = {**load("network", "wav2vec2_fc.yaml"), **exp["network"]}
    assert LARGE["network"] == net
    algo = {**load("optim", "algo", "adam.yaml"), **exp["optim"]["algo"]}
    assert LARGE["optim"]["algo"] == algo
    assert LARGE["optim"]["schedule"] == load("optim", "schedule", "one_cycle.yaml")
    assert LARGE["optim"]["loss"] == load("optim", "loss", "aam_softmax.yaml")
    assert {"override /optim/loss": "aam_softmax"} in exp["defaults"]
    trainer = {**load("trainer", "trainer.yaml"), **exp["trainer"]}
    assert {k: v for k, v in LARGE["trainer"].items() if k not in ("checkpoint_dir", "log_dir")} == {
        k: v for k, v in trainer.items() if k not in ("checkpoint_dir", "log_dir")}
    assert LARGE["data"]["dataloader"]["batch_size"] == exp["data"]["dataloader"]["batch_size"] == 48
    # the CE recipe's network dict holds the same keys
    assert set(CE["network"]) == set(LARGE["network"])
