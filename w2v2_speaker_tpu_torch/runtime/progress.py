"""Embeddings of a fixed probe set over training (``callbacks.progress_tracker``).

Counterpart of ``w2v2_speaker_tpu/runtime/progress.py::ProgressTracker``
(:36): up to ``per_speaker`` training utterances of each of the first
``num_speakers`` speaker indices are picked once from the training stream
(at most ``max_scan_batches`` batches), right-padded to one length, and
embedded at every validation. Each snapshot writes, under
``step_XXXXXXXX/``:

- ``embeddings.npy``: the [N, D] embeddings of the probe set;
- ``stats.txt``: one line per sample (min, max, mean, std, L2 norm, NaNs);
- ``embeddings.png``: a heatmap with a separator between samples, scaled
  to the 2nd-98th percentiles, where matplotlib imports;

and returns the mean intra- and inter-speaker cosine and their gap
(``track_intra_cos``, ``track_inter_cos``, ``track_separation``), which
the run logs beside ``val_eer``.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np

__all__ = ["ProgressTracker"]


class ProgressTracker:
    def __init__(self, out_dir: Union[pathlib.Path, str], num_speakers: int = 5, per_speaker: int = 2,
                 heatmap: bool = True, max_scan_batches: int = 100):
        self.out_dir = pathlib.Path(out_dir)
        self.num_speakers = int(num_speakers)
        self.per_speaker = int(per_speaker)
        self.heatmap = bool(heatmap)
        self.max_scan_batches = int(max_scan_batches)
        self.features: Optional[np.ndarray] = None  # [N, T] probe rows
        self.mask: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None

    def select_samples(self, batches: Iterable[Dict]) -> bool:
        """Pick the probe set from a stream of training batches; False when
        no sample of a tracked speaker appears."""
        by_spk: Dict[int, list] = {}
        want = self.num_speakers * self.per_speaker
        for scanned, batch in enumerate(batches):
            if scanned >= self.max_scan_batches:
                break
            feats = np.asarray(batch["features"])
            labels = np.asarray(batch["labels"]).reshape(-1)
            mask = batch.get("mask")
            mask = np.ones(feats.shape[:2], bool) if mask is None else np.asarray(mask)
            for j in range(min(len(labels), feats.shape[0])):
                lab = int(labels[j])
                if lab >= self.num_speakers:
                    continue
                rows = by_spk.setdefault(lab, [])
                if len(rows) < self.per_speaker:
                    rows.append((feats[j], mask[j], lab))
            if sum(len(v) for v in by_spk.values()) >= want:
                break
        picked = [row for lab in sorted(by_spk) for row in by_spk[lab]]
        if not picked:
            return False
        t_max = max(r[0].shape[0] for r in picked)

        def pad_t(a: np.ndarray) -> np.ndarray:
            return a if a.shape[0] == t_max else np.pad(a, [(0, t_max - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

        self.features = np.stack([pad_t(r[0]) for r in picked])
        self.mask = np.stack([pad_t(r[1]) for r in picked])
        self.labels = np.asarray([r[2] for r in picked])
        return True

    def snapshot(self, step: int, embed_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> Dict[str, float]:
        """Embed the probe set with ``embed_fn(features, mask) -> [N, D]``,
        write the snapshot of ``step``, return the separation metrics."""
        emb = np.asarray(embed_fn(self.features, self.mask))
        d = self.out_dir / f"step_{int(step):08d}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "embeddings.npy", emb)
        lines = [f"sample {j} speaker {int(lab)}: min={e.min():.4f} max={e.max():.4f} mean={e.mean():.4f} "
                 f"std={e.std():.4f} l2={np.linalg.norm(e):.4f} nan={int(np.isnan(e).sum())}"
                 for j, (lab, e) in enumerate(zip(self.labels, emb))]
        (d / "stats.txt").write_text("\n".join(lines) + "\n")
        metrics = self._separation_metrics(emb)
        if self.heatmap:
            self._write_heatmap(emb, d / "embeddings.png")
        return metrics

    def _separation_metrics(self, emb: np.ndarray) -> Dict[str, float]:
        n = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        sims = n @ n.T
        same = self.labels[:, None] == self.labels[None, :]
        intra = sims[same & ~np.eye(len(emb), dtype=bool)]
        inter = sims[~same]
        out: Dict[str, float] = {}
        if intra.size:
            out["track_intra_cos"] = float(intra.mean())
        if inter.size:
            out["track_inter_cos"] = float(inter.mean())
        if intra.size and inter.size:
            out["track_separation"] = float(intra.mean() - inter.mean())
        return out

    def _write_heatmap(self, emb: np.ndarray, path: pathlib.Path) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return  # embeddings.npy holds the data
        lo, hi = np.percentile(emb, [2, 98])
        fig, ax = plt.subplots(figsize=(8, max(2.0, 0.4 * emb.shape[0])))
        ax.imshow(emb, aspect="auto", vmin=lo, vmax=hi, cmap="viridis", interpolation="nearest")
        for i in range(emb.shape[0] + 1):
            ax.axhline(i - 0.5, color="white", lw=2)
        ax.set_yticks(range(emb.shape[0]))
        ax.set_yticklabels([f"spk {int(lab)}" for lab in self.labels])
        ax.set_xlabel("embedding dim")
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)
