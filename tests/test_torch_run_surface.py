"""The ``run.py`` twin's port-only runs on ``tests/test_torch_run.py``'s
corpus (its ``write_corpus`` and ``overrides``: the tiny CE recipe in
float32, every rate at 0): early stopping past ``min_steps``, and the
knobs, networks, optimizers, schedules and callbacks that once raised.
The run surface (``-m`` grids, ``+search``, the SLURM launcher and
``-sc``) is ``tests/test_torch_run_search.py``, on a test worker of its
own. The first run prepares the module's shards; the others read them.
One intra-op thread, as ``tests/test_torch_run.py``."""

import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_run import overrides, write_corpus
from w2v2_speaker_tpu_torch import run as trun


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: at these shapes eight threads buy nothing alone
    and contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(WAV root and trial file, the shards directory every run reads)."""
    tmp = tmp_path_factory.mktemp("torch_run_surface")
    return write_corpus(tmp), tmp / "shards"


def test_early_stopping_ends_the_run_after_min_steps(corpus, tmp_path, capsys):
    """A divergence threshold every EER passes stops the run at the first
    validation at or past ``min_steps``."""
    corpus, shards = corpus
    argv = overrides(corpus, tmp_path, "callbacks=speaker_early_stopping",
                     "callbacks.early_stopping.divergence_threshold=-1.0", "trainer.min_steps=4",
                     "trainer.val_check_interval=2", "trainer.max_steps=12", "trainer.limit_test_batches=1",
                     f"data.module.shards_dir={shards}")
    trun.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "early-stop condition at step 2 suppressed: min_steps=4" in out
    assert "early stopping at step 4: val_eer=" in out
    assert '"last": {\n    "step": 4' in (tmp_path / "ckpt" / "index.json").read_text()



def _find(tree, key):
    """The first value under ``key`` anywhere in a nested dict."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for v in tree.values():
            found = _find(v, key)
            if found is not None:
                return found
    return None


def _last_tx_state(ckpt: pathlib.Path) -> dict:
    return torch.load(ckpt / "last" / "state.pt", map_location="cpu", weights_only=True)["tx"]


@pytest.mark.parametrize("extra", [
    ["verify_model=true"], ["+trainer.dump_first_batch=true"],
    ["data.pipeline.augment.enabled=true", "data.pipeline.augment.noise_snr=[5,10]"],
    ["network=wav2vec_fc"], ["network=wav2vec_xvector"],
    ["optim/algo=sgd"], ["optim/schedule=reduce_on_plateau"], ["callbacks=speaker_progress_tracker"],
    ["run_lr_range_test=true", "tune_iterations=3"], ["tune_model=true", "tune_iterations=3"],
    ["trainer.deterministic=true", "trainer.remat=true", "network.remat_policy=dots"],
    ["profiler=simple", "profiler.start_step=0", "profiler.num_steps=1", "trainer.num_sanity_val_steps=1"],
], ids=["verify_model", "dump_first_batch", "augment", "wav2vec_fc", "wav2vec_xvector", "sgd", "reduce_on_plateau",
        "progress_tracker", "run_lr_range_test", "tune_model", "deterministic_remat", "profiler"])
def test_what_was_not_ported_runs(corpus, tmp_path, capsys, extra):
    """The knobs and networks this test once held to raising now run: one
    step, a validation and one test batch, on the fixture's shards. The
    model summary and the leakage probe's verdict are printed; the first
    batch and 4 samples' stages are dumped; the augmented samples carry the
    effect in their keys; wav2vec v1 trains at its full width; SGD keeps
    its momentum buffers and the plateau schedule its controller in the
    checkpoint; the tracker snapshots its probe set and logs its
    separation metrics; the LR range test writes ``data.json`` and returns
    its suggestion instead of training; ``trainer.deterministic`` (with
    ``trainer.remat``) sets its flags for the run and restores them after;
    ``profiler=simple`` traces its window's step and runs no sanity
    validation."""
    corpus, shards = corpus
    argv = overrides(corpus, tmp_path, f"data.module.shards_dir={shards}",
                     "trainer.max_steps=1", "trainer.val_check_interval=1", "trainer.num_sanity_val_steps=0",
                     "trainer.limit_test_batches=1", *extra)
    if extra[0].startswith("data.pipeline"):
        argv.append("+trainer.dump_first_batch=true")  # the keys of the first batch show the effect
    if extra[0] == "profiler=simple":
        argv.append(f"profiler.trace_dir={tmp_path / 'profile'}")
    objective = trun.main(argv, device="cpu")
    assert objective is None or 0 <= objective <= 1
    out = capsys.readouterr().out
    if extra == ["verify_model=true"]:
        assert "model parameters:" in out and "batch gradient verification: no cross-batch leakage" in out
    if "dump_first_batch" in " ".join(argv):
        keys = eval((tmp_path / "first_batch" / "batch_keys.txt").read_text())
        assert len(keys) == 8 and len(list((tmp_path / "first_batch" / "per_sample").iterdir())) == 4
        assert all(k.endswith("/uniform_noise") == extra[0].startswith("data.pipeline") for k in keys)
    if extra[0].startswith(("run_lr_range_test", "tune_model")):
        data = json.loads((tmp_path / "auto_lr_find" / "data.json").read_text())
        assert sorted(data) == ["loss", "lr", "suggestion"] and len(data["lr"]) == len(data["loss"]) == 3
        assert objective == data["suggestion"] and f"lr suggestion: {objective}" in out
        assert not (tmp_path / "ckpt").exists()
        return
    assert '"last": {\n    "step": 1' in (tmp_path / "ckpt" / "index.json").read_text()
    if extra == ["optim/algo=sgd"]:
        momentum = _find(_last_tx_state(tmp_path / "ckpt"), "sgd")["state"]
        assert momentum and all("momentum_buffer" in v for v in momentum.values())
    if extra == ["optim/schedule=reduce_on_plateau"]:
        assert _find(_last_tx_state(tmp_path / "ckpt"), "schedule") == {
            "best": pytest.approx(json.loads((tmp_path / "ckpt" / "index.json").read_text())["best"][0]["metric"]),
            "bad_count": 0, "factor_value": 1.0}
    if extra[0] == "trainer.deterministic=true":
        assert "trainer.deterministic=true: deterministic algorithms" in out
        assert not torch.are_deterministic_algorithms_enabled()
    if extra[0] == "profiler=simple":
        trace = (tmp_path / "profile" / "trace.json").read_text()
        assert f"profiler: steps 1-1 traced to {tmp_path / 'profile' / 'trace.json'}" in out
        assert '"train_step_1"' in trace and "sanity validation" not in out
    if extra == ["callbacks=speaker_progress_tracker"]:
        emb = np.load(tmp_path / "progress" / "step_00000001" / "embeddings.npy")
        assert emb.shape == (10, 48) and np.isfinite(emb).all()
        assert "track_separation=" in out and "val_eer=" in out
