"""Metrics logging: the port's copy of
``w2v2_speaker_tpu/runtime/logging.py`` (``MetricsLogger`` :33,
``rss_mb`` :21).

Scalars are averaged over a window and flushed every ``flush_every`` steps
to the console and, with a ``log_dir``, to TensorBoard event files
(``tb_writer.py``); each flush adds the process's resident memory, read
from ``/proc/self/status``.
"""

from __future__ import annotations

import pathlib
import time
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["MetricsLogger", "rss_mb"]


def rss_mb() -> float:
    """Resident set size of this process in MiB (host RAM monitor)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0


class MetricsLogger:
    """Windowed scalar logging to console + optional TensorBoard."""

    def __init__(
        self,
        log_dir: Optional[pathlib.Path | str] = None,
        flush_every: int = 100,
        console: bool = True,
    ):
        self.flush_every = flush_every
        self.console = console
        self._window: Dict[str, list] = defaultdict(list)
        self._writer = None
        if log_dir is not None:
            from .tb_writer import TensorBoardWriter

            self._writer = TensorBoardWriter(log_dir)
        self._start = time.time()

    def log_step(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._window[k].append(float(v))
        if step % self.flush_every == 0 and step > 0:
            means = {
                k: sum(v) / len(v) for k, v in self._window.items() if v
            }
            means["ram_mb"] = rss_mb()
            self._emit(step, means, prefix="train")
            self._window.clear()

    def log_eval(self, step: int, metrics: Dict[str, float], split="val"):
        self._emit(step, metrics, prefix=split)

    def log_text(self, step: int, tag: str, text: str) -> None:
        """Console + TensorBoard text (the reference's tracked-sample
        transcription logging, speech_recognition_module.py:249-288)."""
        if self.console:
            print(f"{tag} step {step}: {text}", flush=True)
        if self._writer is not None:
            self._writer.add_text(tag, text, step)

    def _emit(self, step: int, metrics: Dict[str, float], prefix: str):
        if self.console:
            parts = " ".join(
                f"{k}={v:.5g}" for k, v in sorted(metrics.items())
            )
            elapsed = time.time() - self._start
            print(f"[{elapsed:8.1f}s] {prefix} step {step}: {parts}", flush=True)
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(f"{prefix}/{k}", v, step)

    def close(self):
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
