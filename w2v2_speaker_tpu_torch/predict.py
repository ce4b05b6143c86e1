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
(``runtime/completion.py``). ``network.int8_matmuls=true`` serves the
wav2vec2 networks' dense layers in int8, ``auto`` per bucket batch
(``runtime/predict.py::BucketDispatchEmbed``). On an H100 both serve
slower than bf16 (PERF.md §5): ``auto`` keeps the TPU's crossover, which
sends every LARGE bucket and BASE's from 6 s to int8, and the int8 GEMM
does not beat cuBLAS's bf16 yet. There is no compilation
cache to enable: the port compiles nothing but its kernels, which
``ops/_build.py`` keeps by the hash of their sources.

``trainer.num_devices`` (``config/predict.yaml`` composes ``trainer``;
``all`` is every visible card, 1 on the CPU) shards the extraction over N
ranks (``runtime/predict.py``): in the process group that exists
(``torchrun --nproc-per-node N -m w2v2_speaker_tpu_torch.predict ...
trainer.num_devices=N``), else in N ranks this process spawns, NCCL with a
card a rank; rank 0 alone reads the audio and writes the cache and the
scores. A single-process run on a multi-card host says
``trainer.num_devices=1``. ``-sc`` spawns no rank.
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
    for ``-sc``, and on the ranks other than 0 of a caller's group)."""
    overrides = list(sys.argv[1:] if argv is None else argv)
    if overrides[:1] == ["-sc"]:
        from .runtime.completion import handle_shell_completion

        handle_shell_completion(CONFIG_DIR, overrides[1:], entry="predict", module="w2v2_speaker_tpu_torch.predict")
        return None
    cfg = load_config(CONFIG_DIR, "predict", overrides)
    return run_predictions(cfg, device)


if __name__ == "__main__":
    main()
