"""Right-padding collation with bucketed lengths (host-side numpy).

The port's own copies of ``w2v2_speaker_tpu/data/collate.py``:
``PaddedBatch`` (:22), ``bucket_length`` (:40) and ``collate_pad_right``
(:59); and of ``w2v2_speaker_tpu/parallel/mesh.py::pad_batch_rows`` (:72).
Bucketing keeps the set of batch shapes small, so the card sees few
distinct shapes; the masks let the model ignore the padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["PaddedBatch", "bucket_length", "collate_pad_right", "pad_batch_rows"]


@dataclass
class PaddedBatch:
    """values: [batch, max_len] or [batch, max_len, features];
    lengths: [batch] true (unpadded) frame counts."""

    values: np.ndarray
    lengths: np.ndarray

    @property
    def mask(self) -> np.ndarray:
        """Boolean validity mask of shape [batch, max_len]."""
        max_len = self.values.shape[1]
        return np.arange(max_len)[None, :] < self.lengths[:, None]


def bucket_length(
    n: int,
    pad_to_multiple: Optional[int] = None,
    bucket_boundaries: Optional[Sequence[int]] = None,
) -> int:
    """Round a length up to the bucket it falls in."""
    out = n
    if pad_to_multiple is not None and pad_to_multiple > 1:
        out = ((out + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    if bucket_boundaries:
        for b in sorted(bucket_boundaries):
            if out <= b:
                return b
        raise ValueError(
            f"length {out} exceeds largest bucket {max(bucket_boundaries)}"
        )
    return out


def collate_pad_right(
    samples: Sequence[np.ndarray],
    value: float = 0.0,
    pad_to_multiple: Optional[int] = None,
    bucket_boundaries: Optional[Sequence[int]] = None,
    dtype=None,
) -> PaddedBatch:
    """Right-pad 1-D [frames] or 2-D [frames, features] samples and stack."""
    if len(samples) == 0:
        raise ValueError("expected non-empty list of samples")
    ndim = samples[0].ndim
    if ndim not in (1, 2):
        raise ValueError(f"only 1-D or 2-D samples supported, got {ndim}-D")

    num_features = samples[0].shape[1] if ndim == 2 else None
    lengths = np.empty(len(samples), dtype=np.int32)
    for i, s in enumerate(samples):
        if s.ndim != ndim:
            raise ValueError("inconsistent sample dimensionality")
        if ndim == 2 and s.shape[1] != num_features:
            raise ValueError(
                f"inconsistent feature count: {s.shape[1]} vs {num_features}"
            )
        lengths[i] = s.shape[0]

    max_len = bucket_length(int(lengths.max()), pad_to_multiple, bucket_boundaries)
    shape = (len(samples), max_len) + ((num_features,) if ndim == 2 else ())
    out = np.full(shape, value, dtype=dtype or samples[0].dtype)
    for i, s in enumerate(samples):
        out[i, : s.shape[0]] = s
    return PaddedBatch(values=out, lengths=lengths)


def pad_batch_rows(batch: dict, target_rows: int, mask_fill: bool = False) -> dict:
    """Right-pad every array's leading dim to ``target_rows``. Pad rows are
    zeros; the 'mask' entry pads with ``mask_fill`` (False: all-invalid
    rows, which the padding-invariant model paths pool to 0). Callers slice
    outputs back to the true row count."""
    n = next(iter(batch.values())).shape[0]
    pad = target_rows - n
    if pad <= 0:
        return batch
    return {
        k: np.concatenate(
            [v, np.full((pad,) + v.shape[1:], mask_fill if k == "mask" else 0, v.dtype)]
        )
        for k, v in batch.items()
    }
