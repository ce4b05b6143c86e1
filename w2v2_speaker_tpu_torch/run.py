"""Train and evaluate from the command line: the port's twin of the
repository's ``run.py`` (same Hydra grammar, same ``config/train_eval.yaml``
and experiment presets). Runs on the card; ``main(argv, device="cpu")``
runs on the CPU.

    python -m w2v2_speaker_tpu_torch.run +experiment=speaker_wav2vec2_ce \\
        data.module.data_dir=<spk/yt/utt.wav tree> \\
        data.module.shards_dir=<shard output> \\
        data.module.test_trial_path=<trials.txt> trainer.max_steps=1000
    python -m w2v2_speaker_tpu_torch.run +experiment=speech_wav2vec2_ctc \
        data_folder=<dir holding librispeech/train-clean-100, dev-*, test-*>
    python -m w2v2_speaker_tpu_torch.run +experiment=multitask_wav2vec2 \
        data_folder=<the same> [optim/loss=ctc_aam]

Every recipe of ``config/experiment/`` runs, with its options
(``network.wav2vec_feature_encoder_only=true``,
``network.use_transformers_as_ensembles=true``), every network of
``config/network/`` (the wav2vec v1 ones too) and every pipeline of
``config/data/pipeline/`` (the augmented ones too), and
``trainer.dump_first_batch=true`` and ``verify_model=true``. Loads ``KEY=value``
lines of a ``.env`` file in the working directory into the environment
(without overriding), composes the config, runs
``runtime.experiment.run_train_eval`` once, prints ``objective: <EER>``
(``<WER>`` for the speech recipe) and returns it. Grid runs (``-m``), hyperparameter search (``+search``), the
SLURM launcher (``hydra/launcher=...``) and shell completion (``-sc``)
are not ported yet (ROADMAP.md Queue 1 item 3); there is no compilation
cache to enable (item 9).
"""

from __future__ import annotations

import os
import pathlib
import sys
from typing import Optional, Sequence

from .device import DeviceLike
from .runtime.config import load_config
from .runtime.experiment import CONFIG_DIR, run_train_eval

__all__ = ["main"]

_ROW = "ROADMAP.md Queue 1 item 3 (the rest of run.py's surface)"


def _load_dotenv(path: pathlib.Path = pathlib.Path(".env")) -> None:
    if not path.exists():
        return
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        os.environ.setdefault(k.strip(), v.strip())


def _check_single_run(overrides: Sequence[str]) -> None:
    if overrides[:1] == ["-sc"]:
        raise NotImplementedError(f"shell completion (-sc) is not ported yet: {_ROW}")
    if any(ov in ("-m", "--multirun") for ov in overrides):
        raise NotImplementedError(f"multirun grids (-m) are not ported yet: {_ROW}")
    for ov in overrides:
        key = ov.partition("=")[0].lstrip("+")
        if key == "search":
            raise NotImplementedError(f"hyperparameter search (+search) is not ported yet: {_ROW}")
        if key == "hydra/launcher" or key.startswith("hydra.launcher."):
            raise NotImplementedError(f"the SLURM launcher (hydra/launcher) is not ported yet: {_ROW}")


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> Optional[float]:
    """Compose ``config/train_eval.yaml`` with ``argv`` (default: the
    command line), train and test once; returns the objective."""
    _load_dotenv()
    overrides = list(sys.argv[1:] if argv is None else argv)
    _check_single_run(overrides)
    cfg = load_config(CONFIG_DIR, "train_eval", overrides)
    objective = run_train_eval(cfg, device)
    print(f"objective: {objective}")
    return objective


if __name__ == "__main__":
    main()
