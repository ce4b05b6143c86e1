"""The ``run.py`` twin's run surface on ``tests/test_torch_run.py``'s corpus
(its ``write_corpus`` and ``overrides``: the tiny CE recipe in float32,
every rate at 0): ``-m`` grids, ``+search``, the SLURM launcher and
``-sc``. The first run prepares the module's shards; the others read
them. One intra-op thread, as ``tests/test_torch_run.py``. (Split from
``tests/test_torch_run_surface.py``, so that two test workers share the
load.)"""

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
    tmp = tmp_path_factory.mktemp("torch_run_search")
    return write_corpus(tmp), tmp / "shards"


@pytest.mark.parametrize("extra", [
    ["-m", "network.stat_pooling_type=mean,max"], ["--multirun", "seed=3,4", "eval_model=false"],
    ["-m", "+search=lr_and_pooling", "search.n_trials=2", "search.n_startup_trials=1"],
    ["-m", "hydra/launcher=slurm", "network.stat_pooling_type=mean,max"],
], ids=["multirun", "multirun_long_flag", "search", "slurm_launcher"])
def test_run_surface_runs(corpus, tmp_path, capsys, extra):
    """``-m`` grids (one checkpoint directory per run, the summary, the
    best objective; None for train-only runs), a 2-trial ``+search`` (a directory per trial that was
    not pruned, the best printed) and the SLURM launcher (the array script
    of the grid, nothing trained), on the fixture's shards."""
    corpus, shards = corpus
    argv = overrides(corpus, tmp_path, f"data.module.shards_dir={shards}",
                     "trainer.max_steps=1", "trainer.val_check_interval=1", "trainer.num_sanity_val_steps=0",
                     "trainer.limit_test_batches=4", *extra)  # 16 test utterances, 8 of the trials
    objective = trun.main(argv, device="cpu")
    out = capsys.readouterr().out
    if "hydra/launcher=slurm" in extra:
        script = (tmp_path / "ckpt" / ".slurm" / "sweep.sbatch").read_text()
        assert objective != objective and "#SBATCH --array=0-1%4" in script
        assert script.count("-m w2v2_speaker_tpu_torch.run") == 2 and "job1" in script
        assert not (tmp_path / "ckpt" / "job0").exists()
        return
    if "+search=lr_and_pooling" in extra:
        assert out.count("=== search trial") == 2 and "=== search [lr_and_pooling] best objective" in out
        trials = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
        assert trials and set(trials) <= {"trial0", "trial1"}
        assert 0 <= objective <= 1 and f"objective: {objective}" in out
        return
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["job0", "job1"]
    assert all((tmp_path / "ckpt" / job / "index.json").exists() for job in ("job0", "job1"))
    assert out.count("=== multirun job") == 2 and "=== multirun summary (sorted by objective)" in out
    assert out.rstrip().endswith(f"objective: {objective}")
    if "eval_model=false" in extra:  # train-only runs: no objective, listed as None
        assert objective is None and out.count("None     [") == 2
    else:
        assert 0 <= objective <= 1


def test_shell_completion_runs(capsys):
    """``-sc``: the bash script to eval, and candidates for a prefix."""
    assert trun.main(["-sc", "install=bash"], device="cpu") is None
    assert "_w2v2_torch_sc" in capsys.readouterr().out
    assert trun.main(["-sc", "query=+experiment=speaker_x"], device="cpu") is None
    assert capsys.readouterr().out.split() == ["+experiment=speaker_xvector"]
