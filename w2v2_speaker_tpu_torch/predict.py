"""Embedding extraction and pair scoring from the command line: the port's
twin of the repository's ``predict.py`` (same Hydra grammar, same
``config/predict.yaml``). Runs on the card; ``main(argv, device="cpu")``
runs on the CPU.

    python -m w2v2_speaker_tpu_torch.predict network=wav2vec2_fc \\
        load_network_from_checkpoint=<weights .npz or .pt> \\
        predict_folder_path=<wav dir> pair_prediction_path=<pairs.txt>

``load_network_from_checkpoint`` takes a torch ``state_dict`` of the port's
model or an ``.npz`` exported from a JAX-package checkpoint with
``tools/export_jax_params.py``. ``-sc install=bash`` / ``-sc
query=<word>`` answer shell completion over ``config/predict.yaml``
(``runtime/completion.py``). There is no compilation cache to enable
(ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import pathlib
import sys
from typing import Optional, Sequence

from .device import DeviceLike
from .runtime.config import load_config
from .runtime.experiment import CONFIG_DIR
from .runtime.predict import run_predictions

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> Optional[pathlib.Path]:
    """Compose ``config/predict.yaml`` with ``argv`` (default: the command
    line) and run ``run_predictions``; returns the score file's path (None
    for ``-sc``)."""
    overrides = list(sys.argv[1:] if argv is None else argv)
    if overrides[:1] == ["-sc"]:
        from .runtime.completion import handle_shell_completion

        handle_shell_completion(CONFIG_DIR, overrides[1:], entry="predict", module="w2v2_speaker_tpu_torch.predict")
        return None
    cfg = load_config(CONFIG_DIR, "predict", overrides)
    return run_predictions(cfg, device)


if __name__ == "__main__":
    main()
