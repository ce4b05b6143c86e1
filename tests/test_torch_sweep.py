"""The run twin's sweep surface against the JAX package's on the CPU, with
no model:

- the TPE sampler (``runtime/sweeper.py``): the trials asked at one seed
  over each preset of ``config/search/``, with the same objectives told
  (the startup trials from the prior, then the estimator's), equal value
  for value; ``format_override``;
- ``run.py``'s ``_expand_multirun``: the same grids;
- the SLURM array script of ``runtime/slurm.py`` for the launcher config
  and its knobs: line for line the JAX package's but for the task lines,
  which run ``python -m w2v2_speaker_tpu_torch.run`` with the same
  overrides; written and not submitted without ``sbatch``;
- shell completion (``runtime/completion.py``): the same candidates for a
  set of prefixes, for ``config/train_eval.yaml`` and
  ``config/predict.yaml``, and the ``-sc`` branch of both twins.
"""

import contextlib
import io
import math
import pathlib
import shlex

import pytest
import yaml

import predict as jpredict
import run as jrun
from w2v2_speaker_tpu.runtime import completion as jcompletion
from w2v2_speaker_tpu.runtime import slurm as jslurm
from w2v2_speaker_tpu.runtime import sweeper as jsweeper
from w2v2_speaker_tpu_torch import predict as tpredict
from w2v2_speaker_tpu_torch import run as trun
from w2v2_speaker_tpu_torch.runtime import completion as tcompletion
from w2v2_speaker_tpu_torch.runtime import slurm as tslurm
from w2v2_speaker_tpu_torch.runtime import sweeper as tsweeper

CONFIG = pathlib.Path(__file__).resolve().parents[1] / "config"
PRESETS = sorted(p.stem for p in (CONFIG / "search").glob("*.yaml"))
PREFIXES = ["", "net", "network=", "network=wav", "+experiment=speaker_w", "+search=lr", "optim.", "optim.loss=a",
            "trainer.max", "hydra/launcher=", "data.module.", "callbacks=speaker_p", "nothing.here"]


def _objective(params) -> float:
    """A deterministic objective of a trial's values (lr near 1e-4 and the
    first categorical choice are best)."""
    score = 0.0
    for k, v in sorted(params.items()):
        if isinstance(v, float) and k.endswith("lr"):
            score += abs(math.log10(v) + 4)
        elif isinstance(v, (int, float)):
            score += 0.01 * float(v)
        else:
            score += 0.1 * len(str(v))
    return score


@pytest.mark.parametrize("preset", PRESETS)
def test_tpe_asks_the_same_trials_as_jax(preset):
    space = yaml.safe_load((CONFIG / "search" / f"{preset}.yaml").read_text())["search"]["search_space"]
    samplers = [mod.TPESampler(space, seed=123, n_startup_trials=4) for mod in (tsweeper, jsweeper)]
    asked = []
    for _ in range(12):
        trial = [s.ask() for s in samplers]
        assert trial[0] == trial[1]
        assert [tsweeper.format_override(k, v) for k, v in trial[0].items()] == [
            jsweeper.format_override(k, v) for k, v in trial[1].items()]
        for s, params in zip(samplers, trial):
            s.tell(params, _objective(params))
        asked.append(trial[0])
    assert samplers[0].best == samplers[1].best
    assert len({str(a) for a in asked}) == len(asked)  # the estimator moved


def test_format_override_and_grid_expansion_match_jax():
    for key, value in (("optim.algo.lr", 1.2345678901234e-5), ("optim.loss.scale", 7),
                       ("network.stat_pooling_type", "mean+std"), ("optim.algo.weight_decay", 0)):
        assert tsweeper.format_override(key, value) == jsweeper.format_override(key, value)
    for overrides in (["a=1"], ["a=1,2", "b=x,y,z", "c=[1,2]", "d={e: 1, f: 2}", "+experiment=speaker_xvector"],
                      ["network.stat_pooling_type=mean,max", "trainer.max_steps=2"], []):
        assert trun._expand_multirun(overrides) == jrun._expand_multirun(overrides)
    assert len(trun._expand_multirun(["a=1,2", "b=x,y,z", "c=[1,2]"])) == 6


@pytest.mark.parametrize("knobs", [[], ["hydra.launcher.array_parallelism=7", "hydra.launcher.exclude=cn104",
                                        "hydra.launcher.gres=gpu:1", "hydra.launcher.partition=gpu",
                                        "hydra.launcher.additional_parameters={qos: high}"]],
                         ids=["defaults", "knobs"])
def test_sbatch_script_matches_jax_but_the_program(tmp_path, capsys, knobs):
    runs = [["+experiment=speaker_xvector", "trainer.max_steps=2", f"trainer.checkpoint_dir={tmp_path}/c/job{i}",
             f"network.stat_pooling_type={p}"] for i, p in enumerate(("mean", "max"))]
    launcher, rest = trun._pop_launcher(["hydra/launcher=slurm", *knobs, "x=1"])
    assert (launcher, rest) == jrun._pop_launcher(["hydra/launcher=slurm", *knobs, "x=1"]) and rest == ["x=1"]
    scripts = {}
    for name, mod in (("jax", jslurm), ("torch", tslurm)):
        path = mod.launch_slurm(launcher, runs, tmp_path / "sweep", submit=False)
        scripts[name] = path.read_text().splitlines()
    assert "sbatch not found" in capsys.readouterr().out
    jax_lines, torch_lines = scripts["jax"], scripts["torch"]
    start = jax_lines.index("CMDS=(")
    assert torch_lines[:start + 1] == jax_lines[:start + 1] and torch_lines[-2:] == jax_lines[-2:]
    assert len(torch_lines) == len(jax_lines) == start + 1 + len(runs) + 2
    for ovs, line in zip(runs, torch_lines[start + 1:start + 1 + len(runs)], strict=True):
        words = shlex.split(shlex.split(line)[0])
        assert words[0].startswith("PYTHONPATH=") and words[2:4] == ["-m", "w2v2_speaker_tpu_torch.run"]
        assert words[4:] == ovs
    if knobs:
        assert "#SBATCH --gres=gpu:1" in torch_lines and "#SBATCH --array=0-1%7" in torch_lines
        assert "#SBATCH --qos=high" in torch_lines


def test_launcher_grid_writes_job_dirs_without_resolving_the_template(tmp_path, capsys):
    """``-m hydra/launcher=slurm``: the array script of a 2-point grid, each
    task with its own ``job<i>`` under the unresolved checkpoint template
    (the JAX package's command line, but for the program)."""
    argv = ["-m", "hydra/launcher=slurm", f"hydra.launcher.submitit_folder={tmp_path / 'sweep'}",
            "+experiment=speaker_xvector", "network.stat_pooling_type=mean,max"]
    got = trun.main(argv, device="cpu")
    torch_script = (tmp_path / "sweep" / "sweep.sbatch").read_text()
    want = jrun.main(list(argv))
    jax_script = (tmp_path / "sweep" / "sweep.sbatch").read_text()
    assert got != got and want != want  # NaN: the array tasks produce the objectives
    lines = [shlex.split(shlex.split(line)[0]) for line in torch_script.splitlines() if line.startswith("  ")]
    jax_tasks = [shlex.split(shlex.split(line)[0]) for line in jax_script.splitlines() if line.startswith("  ")]
    assert [w[4:] for w in lines] == [w[2:] for w in jax_tasks] and len(lines) == 2
    for i, words in enumerate(lines):
        assert words[-1].startswith("trainer.checkpoint_dir=") and words[-1].endswith(f"/job{i}")
        assert "${" in words[-1]  # resolved in each task, not at submission
    assert capsys.readouterr().out.count("sbatch not found") == 2


@pytest.mark.parametrize("entry", ["train_eval", "predict"])
def test_completion_candidates_match_jax(entry):
    for word in PREFIXES:
        got = tcompletion.candidates(CONFIG, word, entry=entry)
        assert got == jcompletion.candidates(CONFIG, word, entry=entry), word
    assert tcompletion.candidates(CONFIG, "network=", entry=entry)
    assert tcompletion.discover_groups(CONFIG) == jcompletion.discover_groups(CONFIG)


def _printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


@pytest.mark.parametrize("twin", ["run", "predict"])
def test_shell_completion_branch_of_both_twins(twin):
    tmain, jmain = (trun.main, jrun.main) if twin == "run" else (tpredict.main, jpredict.main)
    for word in ("net", "+search=", "trainer.max_st"):
        got, printed = _printed(tmain, ["-sc", f"query={word}"], device="cpu")
        _, want = _printed(jmain, ["-sc", f"query={word}"])
        assert got is None and printed == want and printed.strip()
    _, script = _printed(tmain, ["-sc", "install=bash"], device="cpu")
    assert f"-m w2v2_speaker_tpu_torch.{twin} -sc install=bash" in script
    assert "complete -o nospace -o default -F _w2v2_torch_sc python python3" in script
    assert '"-m w2v2_speaker_tpu_torch.run"|"-m w2v2_speaker_tpu_torch.predict"' in script
    with pytest.raises(SystemExit):
        tmain(["-sc", "install=zsh"], device="cpu")
