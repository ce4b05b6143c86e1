"""Train and evaluate from the command line: the port's twin of the
repository's ``run.py`` (same Hydra grammar, same ``config/train_eval.yaml``
and experiment presets). Runs on the card; ``main(argv, device="cpu")``
runs on the CPU.

    python -m w2v2_speaker_tpu_torch.run +experiment=speaker_wav2vec2_ce \\
        data.module.data_dir=<spk/yt/utt.wav tree> \\
        data.module.shards_dir=<shard output> \\
        data.module.test_trial_path=<trials.txt> trainer.max_steps=1000
    python -m w2v2_speaker_tpu_torch.run +experiment=speech_wav2vec2_ctc \\
        data_folder=<dir holding librispeech/train-clean-100, dev-*, test-*>
    python -m w2v2_speaker_tpu_torch.run -m network.stat_pooling_type=mean,max ...
    python -m w2v2_speaker_tpu_torch.run -m +search=lr_and_pooling search.n_trials=32 ...
    python -m w2v2_speaker_tpu_torch.run -m hydra/launcher=slurm \\
        hydra.launcher.gres=gpu:1 optim.algo.lr=1e-4,1e-5 ...
    eval "$(python -m w2v2_speaker_tpu_torch.run -sc install=bash)"

Every recipe of ``config/experiment/``, network, pipeline, optimizer,
schedule and callback of ``config/`` runs, and so do ``run_lr_range_test``
/ ``tune_model`` (the LR range test's suggestion is the objective).
Loads ``KEY=value`` lines of a ``.env`` file in the working directory
into the environment (without overriding) and composes the config.

- One run: ``runtime.experiment.run_train_eval`` once; prints
  ``objective: <EER>`` (``<WER>`` for the speech recipe) and returns it.
- ``-m`` / ``--multirun``: a grid, ``key=a,b`` fanning out (a list
  ``[a,b]`` does not); run ``i`` checkpoints under
  ``<trainer.checkpoint_dir>/job<i>``; the runs are printed by objective
  and the best one returned.
- ``+search=<preset>``: ``search.n_trials`` trials of the TPE sampler of
  ``runtime/sweeper.py``, each composing the preset with its sampled
  overrides and checkpointing under ``<checkpoint_dir>/trial<i>``; the
  sampler is told each objective, and the best is printed and returned.
  A search needs ``eval_model=true``.
- ``hydra/launcher=slurm`` (with ``hydra.launcher.<knob>=value``): the
  runs are written as one SLURM array script (``runtime/slurm.py``) and
  submitted where ``sbatch`` exists; returns NaN.
- ``-sc install=bash`` / ``-sc query=<word>``: shell completion
  (``runtime/completion.py``).
- ``trainer.num_devices=N``: N data-parallel ranks (``run_train_eval``),
  spawned by the run on this host, or the ranks of ``torchrun
  --nproc-per-node N -m w2v2_speaker_tpu_torch.run ...``; each run of a
  grid or a search spawns its own.

Where the JAX package prunes a search trial that raised
``FloatingPointError``, ``ValueError`` or ``RuntimeError``, the port
prunes those too, except a failure of the card or of a kernel
(``device.is_device_failure``: no card, a failed kernel build or launch, a
CUDA, cuBLAS or cuDNN error, out of memory), which PyTorch raises as a
``RuntimeError`` as well: that ends the search with the error. Each search
trial and grid run builds its model afresh in this process; the previous
one's model, optimizer and cached CUDA memory are freed before it, and the
memory held is printed at its start. There is no compilation cache to
enable: the port compiles nothing but its kernels, which ``ops/_build.py``
keeps by the hash of their sources. ``trainer.deterministic=true`` sets
``CUBLAS_WORKSPACE_CONFIG`` itself when the run is the process's first
CUDA work (``runtime/experiment.py::deterministic_mode``).
"""

from __future__ import annotations

import gc
import itertools
import math
import os
import pathlib
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from .device import DeviceLike, is_device_failure
from .runtime.config import load_config
from .runtime.experiment import CONFIG_DIR, run_train_eval

__all__ = ["main"]


def _load_dotenv(path: pathlib.Path = pathlib.Path(".env")) -> None:
    if not path.exists():
        return
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        os.environ.setdefault(k.strip(), v.strip())


def _expand_multirun(overrides: Sequence[str]) -> List[List[str]]:
    """The grid of ``overrides``: every ``key=a,b`` fans out (a list
    ``[a,b]`` or a dict ``{...}`` does not)."""
    fixed, axes = [], []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if "," in raw and not raw.strip().startswith(("[", "{")):
            axes.append([(key, v) for v in raw.split(",")])
        else:
            fixed.append(ov)
    if not axes:
        return [list(overrides)]
    return [fixed + [f"{k}={v}" for k, v in combo] for combo in itertools.product(*axes)]


def _fresh_run(label: str) -> None:
    """Free what the previous run of this process left (its model and
    optimizer, the allocator's cache) and print the memory held."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        print(f"{label}: {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated on the card at its start")


def _run_search(overrides: Sequence[str], device: DeviceLike) -> float:
    """TPE search over the preset of ``+search``; returns the best
    objective."""
    from .runtime.sweeper import TPESampler, format_override

    base_cfg = load_config(CONFIG_DIR, "train_eval", overrides)
    scfg = base_cfg.get("search") or {}
    if not scfg.get("search_space"):
        raise SystemExit("search preset has no search_space (use +search=<preset>)")
    if not base_cfg.get("eval_model", True):
        raise SystemExit("hyperparameter search requires eval_model=true (the objective is the evaluation EER/WER)")
    sampler = TPESampler(scfg["search_space"], seed=int(scfg.get("seed", 123)),
                         n_startup_trials=int(scfg.get("n_startup_trials", 10)),
                         direction=scfg.get("direction", "minimize"))
    n_trials = int(scfg.get("n_trials", 128))
    study = scfg.get("study_name", "search")
    base_ckpt = str(base_cfg["trainer"]["checkpoint_dir"])
    for i in range(n_trials):
        params = sampler.ask()
        trial_ovs = [format_override(k, v) for k, v in params.items()]
        print(f"=== search trial {i}/{n_trials} [{study}]: {trial_ovs}")
        _fresh_run(f"trial {i}")
        cfg = load_config(CONFIG_DIR, "train_eval", [*overrides, *trial_ovs])
        cfg["trainer"]["checkpoint_dir"] = f"{base_ckpt}/trial{i}"
        try:
            objective = run_train_eval(cfg, device)
            objective = float(objective) if objective is not None else None
        except (FloatingPointError, ValueError, RuntimeError) as e:
            if is_device_failure(e):
                raise  # the card or a kernel failed: not a bad trial
            print(f"trial {i} failed: {e!r}")
            continue
        if objective is None:
            print(f"trial {i} produced no objective; pruned")
            continue
        sampler.tell(params, objective)
        print(f"trial {i} objective: {objective}")
    best_params, best = sampler.best
    print(f"=== search [{study}] best objective: {best}")
    for k, v in best_params.items():
        print(f"  {format_override(k, v)}")
    print(f"objective: {best}")
    return best


def _pop_launcher(overrides: Sequence[str]) -> Tuple[Optional[dict], List[str]]:
    """(the launcher config of ``hydra/launcher=<name>`` with its
    ``hydra.launcher.<knob>=value`` overrides, or None; the other
    overrides)."""
    name, knobs, rest = None, [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key.lstrip("+") == "hydra/launcher":
            name = val
        elif key.startswith("hydra.launcher."):
            knobs.append((key[len("hydra.launcher."):], val))
        else:
            rest.append(ov)
    if name is None:
        return None, rest
    import yaml

    path = CONFIG_DIR / "hydra" / "launcher" / f"{name}.yaml"
    if not path.exists():
        raise SystemExit(f"unknown launcher {name!r} ({path} missing)")
    launcher = yaml.safe_load(path.read_text()) or {}
    for k, v in knobs:
        launcher[k] = yaml.safe_load(v)
    return launcher, rest


def _launch(launcher: dict, overrides: List[str], multirun: bool) -> float:
    """The runs as a SLURM array job. A grid run's checkpoint directory is
    ``<checkpoint_dir>/job<i>`` with ``checkpoint_dir`` composed
    unresolved, so that a ``${...}`` template (a fresh experiment name) is
    resolved in each task, as its log directory is."""
    from .runtime.slurm import launch_slurm

    runs = _expand_multirun(overrides) if multirun else [overrides]
    base_cfg = load_config(CONFIG_DIR, "train_eval", overrides)
    sweep_dir = launcher.get("submitit_folder") or str(base_cfg["trainer"]["checkpoint_dir"]) + "/.slurm"
    if multirun:
        runs = [ovs + [f"trainer.checkpoint_dir="
                       f"{load_config(CONFIG_DIR, 'train_eval', ovs, resolve_interpolations=False)['trainer']['checkpoint_dir']}"
                       f"/job{i}"]
                for i, ovs in enumerate(runs)]
    launch_slurm(launcher, runs, pathlib.Path(sweep_dir))
    return math.nan  # the array tasks produce the objectives


def _run_grid(overrides: List[str], device: DeviceLike) -> Optional[float]:
    results = []
    for i, run_overrides in enumerate(_expand_multirun(overrides)):
        print(f"=== multirun job {i}: {run_overrides}")
        _fresh_run(f"job {i}")
        cfg = load_config(CONFIG_DIR, "train_eval", run_overrides)
        cfg["trainer"]["checkpoint_dir"] = str(cfg["trainer"]["checkpoint_dir"]) + f"/job{i}"
        results.append((run_overrides, run_train_eval(cfg, device)))
    print("=== multirun summary (sorted by objective)")
    results.sort(key=lambda r: (r[1] is None, r[1] if r[1] is not None else 0.0))  # train-only runs last
    for run_overrides, objective in results:
        shown = f"{objective:.5f}" if objective is not None else "None   "
        print(f"{shown}  {run_overrides}")
    best = results[0][1]
    print(f"objective: {best}")
    return best


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> Optional[float]:
    """Compose ``config/train_eval.yaml`` with ``argv`` (default: the
    command line) and run it once, as a grid, a search or a SLURM array;
    returns the objective (None for ``-sc``)."""
    _load_dotenv()
    overrides = list(sys.argv[1:] if argv is None else argv)
    if overrides[:1] == ["-sc"]:
        from .runtime.completion import handle_shell_completion

        handle_shell_completion(CONFIG_DIR, overrides[1:])
        return None
    multirun = any(ov in ("-m", "--multirun") for ov in overrides)
    overrides = [ov for ov in overrides if ov not in ("-m", "--multirun")]
    launcher, overrides = _pop_launcher(overrides)
    if launcher is not None:
        return _launch(launcher, overrides, multirun)
    if any(ov.split("=", 1)[0].lstrip("+") == "search" for ov in overrides):
        return _run_search(overrides, device)
    if multirun:
        return _run_grid(overrides, device)
    cfg = load_config(CONFIG_DIR, "train_eval", overrides)
    objective = run_train_eval(cfg, device)
    print(f"objective: {objective}")
    return objective


if __name__ == "__main__":
    main()
