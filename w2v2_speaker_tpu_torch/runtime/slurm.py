"""SLURM array jobs for grid runs (``hydra/launcher=slurm``).

Counterpart of ``w2v2_speaker_tpu/runtime/slurm.py``: a sweep is rendered
as one ``sbatch`` array script, task i running
``python -m w2v2_speaker_tpu_torch.run <overrides_i>`` (the package's
directory put on ``PYTHONPATH``) in its own allocation, and submitted
with ``sbatch``. The knobs are those of ``config/hydra/launcher/slurm.yaml``
(``array_parallelism``, ``timeout_min``, ``cpus_per_task``, ``mem_gb``,
``gres`` such as ``gpu:1``, ``partition``, ``exclude``, ...). Without
``sbatch`` on ``PATH`` the script is written and not submitted.
"""

from __future__ import annotations

import pathlib
import shlex
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

__all__ = ["launch_slurm", "render_sbatch"]

MODULE = "w2v2_speaker_tpu_torch.run"
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


def render_sbatch(launcher: Dict, commands: Sequence[str], sweep_dir: pathlib.Path) -> str:
    """One sbatch array script running ``commands[i]`` as task i."""
    lines = ["#!/bin/bash"]

    def opt(flag: str, value) -> None:
        if value is None or value == "":
            return
        lines.append(f"#SBATCH --{flag}={value}")

    n = len(commands)
    par = int(launcher.get("array_parallelism", 4))
    opt("job-name", launcher.get("name", "w2v2-speaker-tpu"))
    lines.append(f"#SBATCH --array=0-{n - 1}%{par}")
    opt("time", launcher.get("timeout_min"))
    opt("cpus-per-task", launcher.get("cpus_per_task"))
    mem = launcher.get("mem_gb")
    opt("mem", f"{mem}G" if mem else None)
    opt("nodes", launcher.get("nodes", 1))
    opt("ntasks-per-node", launcher.get("tasks_per_node", 1))
    opt("gres", launcher.get("gres"))
    opt("partition", launcher.get("partition"))
    opt("constraint", launcher.get("constraint"))
    opt("exclude", launcher.get("exclude"))
    opt("comment", launcher.get("comment"))
    sig = launcher.get("signal_delay_s")
    opt("signal", f"USR1@{sig}" if sig else None)
    opt("output", str(sweep_dir / "%A_%a.out"))
    for key, value in (launcher.get("additional_parameters") or {}).items():
        opt(key, value)
    lines += ["", "CMDS=("]
    lines += [f"  {shlex.quote(cmd)}" for cmd in commands]
    lines += [")", 'eval "${CMDS[$SLURM_ARRAY_TASK_ID]}"']
    return "\n".join(lines) + "\n"


def task_command(overrides: Sequence[str], python: Optional[str] = None) -> str:
    """The shell command of one array task."""
    parts = [f"PYTHONPATH={shlex.quote(str(PACKAGE_ROOT))}", shlex.quote(python or sys.executable), "-m", MODULE]
    return " ".join(parts + [shlex.quote(ov) for ov in overrides])


def launch_slurm(launcher: Dict, run_overrides: Sequence[Sequence[str]], sweep_dir: pathlib.Path,
                 python: Optional[str] = None, submit: Optional[bool] = None) -> pathlib.Path:
    """Write ``<sweep_dir>/sweep.sbatch`` for one override list per task
    (the grid already expanded) and submit it with ``sbatch``; ``submit``
    None submits when ``sbatch`` is on ``PATH``. Returns the script's
    path."""
    sweep_dir = pathlib.Path(sweep_dir)
    sweep_dir.mkdir(parents=True, exist_ok=True)
    commands: List[str] = [task_command(ovs, python) for ovs in run_overrides]
    path = sweep_dir / "sweep.sbatch"
    path.write_text(render_sbatch(launcher, commands, sweep_dir))
    if submit is None:
        submit = shutil.which("sbatch") is not None
    if submit:
        out = subprocess.run(["sbatch", str(path)], capture_output=True, text=True)
        print(out.stdout.strip() or out.stderr.strip())
        if out.returncode != 0:
            raise RuntimeError(f"sbatch failed: {out.stderr.strip()}")
    else:
        print(f"sbatch not found: array script written to {path} ({len(commands)} jobs); "
              f"submit with `sbatch {path}`")
    return path
