"""The port's Hydra-grammar config loader (``runtime/config.py``) against the
JAX package's: the same merged dict for every ``config/experiment/*.yaml``
under ``train_eval`` and for ``predict``, with no overrides and with
dotted, ``+experiment=``, group, list, float and ``${oc.env:}`` overrides.
Equal as dicts; ``random_uuid`` values (one per compose, so different in
every load) are compared by their shape only."""

import pathlib
import re

import pytest

from w2v2_speaker_tpu.runtime.config import load_config as jax_load_config
from w2v2_speaker_tpu_torch.runtime import experiment as texp
from w2v2_speaker_tpu_torch.runtime.config import ConfigError, load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "config"
EXPERIMENTS = sorted(p.stem for p in (CONFIG / "experiment").glob("*.yaml"))
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-[0-9a-f]{12}")
OVERRIDES = {
    "none": [],
    "dotted": ["trainer.max_steps=7", "optim.algo.lr=3e-3", "data.dataloader.batch_size=12"],
    "group": ["network=wav2vec2_fc", "evaluator=cosine_distance_asnorm", "optim/loss=aam_softmax"],
    "list": ["network.hidden_fc_layers_out=[64, 32]", "network.conv_impl=fused_pallas"],
    "env": ["tag=${oc.env:W2V2_CONFIG_TEST_TAG}", "log_folder=${oc.env:W2V2_CONFIG_TEST_MISSING, /tmp/x}"],
}


def _shape_of_uuids(value):
    if isinstance(value, dict):
        return {k: _shape_of_uuids(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape_of_uuids(v) for v in value]
    if isinstance(value, str):
        return UUID.sub("<uuid4>", value)
    return value


def _both(name, overrides):
    got = load_config(CONFIG, name, overrides)
    want = jax_load_config(CONFIG, name, overrides)
    return _shape_of_uuids(got), _shape_of_uuids(want)


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_every_experiment_matches_jax(experiment, monkeypatch):
    monkeypatch.setenv("DATA_FOLDER", "/srv/voxceleb")
    got, want = _both("train_eval", [f"+experiment={experiment}"])
    assert got == want
    assert got["experiment_preset"] == experiment and got["data_folder"] == "/srv/voxceleb"


@pytest.mark.parametrize("kind", sorted(OVERRIDES))
@pytest.mark.parametrize("name", ["train_eval", "predict"])
def test_overrides_match_jax(name, kind, monkeypatch):
    monkeypatch.setenv("W2V2_CONFIG_TEST_TAG", "run-17")
    monkeypatch.delenv("W2V2_CONFIG_TEST_MISSING", raising=False)
    overrides = OVERRIDES[kind]
    if name == "train_eval":
        overrides = ["+experiment=speaker_wav2vec2_large_aam", *overrides]
    got, want = _both(name, overrides)
    assert got == want
    if kind == "env":
        assert got["tag"] == "run-17" and got["log_folder"] == "/tmp/x"
    if kind == "list":
        assert got["network"]["hidden_fc_layers_out"] == [64, 32]


def test_random_uuid_is_one_per_compose():
    cfg = load_config(CONFIG, "train_eval", ["+experiment=speaker_wav2vec2_ce"])
    (name,) = set(UUID.findall(str(cfg)))
    assert cfg["experiment_name"] == name and name in cfg["trainer"]["checkpoint_dir"]
    assert name not in str(load_config(CONFIG, "train_eval", ["+experiment=speaker_wav2vec2_ce"]))


def test_errors_match_jax():
    for overrides in (["trainer.max_steps"], ["+experiment=no_such_preset"], ["network=no_such_net"]):
        with pytest.raises(ConfigError):
            load_config(CONFIG, "train_eval", overrides)
        with pytest.raises(Exception):
            jax_load_config(CONFIG, "train_eval", overrides)


def test_recipes_come_from_config():
    """``load_recipe`` is ``load_config`` of ``train_eval`` with the preset."""
    got = _shape_of_uuids(texp.load_recipe("speaker_wav2vec2_large_aam", ["trainer.max_steps=5"]))
    want = _shape_of_uuids(jax_load_config(
        CONFIG, "train_eval", ["+experiment=speaker_wav2vec2_large_aam", "trainer.max_steps=5"]))
    assert got == want and got["trainer"]["max_steps"] == 5
    assert texp.CONFIG_DIR == CONFIG
