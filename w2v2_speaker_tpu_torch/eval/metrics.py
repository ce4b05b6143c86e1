"""Speaker-verification metrics (copy of ``w2v2_speaker_tpu/eval/metrics.py``).

- ``roc_points`` (:48): sklearn ``roc_curve`` semantics, collinear points
  dropped on request, the (0, 0) origin prepended;
- ``calculate_eer`` (:116): the equal error rate solved in closed form on
  the piecewise-linear ROC, and its threshold;
- ``calculate_mdc`` (:159): the Kaldi minimum detection cost sweep
  (p_target 0.05, c_miss = c_fa = 1), stable ascending sort, first
  minimum;
- ``calculate_wer`` (:226): the corpus word error rate of the speech task
  (sum of word edits over sum of reference words), with
  ``_edit_distance`` (:201), Levenshtein over words in two DP rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "calculate_eer",
    "calculate_mdc",
    "calculate_wer",
    "roc_points",
]


def _validate_scores(groundtruth: np.ndarray, predictions: np.ndarray) -> None:
    if groundtruth.shape[0] != predictions.shape[0]:
        raise ValueError(
            f"length mismatch: groundtruth={groundtruth.shape[0]} "
            f"predictions={predictions.shape[0]}"
        )
    if groundtruth.shape[0] == 0:
        raise ValueError("empty score lists")
    if not np.all(np.isin(groundtruth, [0, 1])):
        raise ValueError(
            f"groundtruth must be 0/1, got values {np.unique(groundtruth)}"
        )
    if np.any(np.isnan(predictions)):
        raise ValueError("NaN in prediction scores")


def roc_points(
    groundtruth: np.ndarray,
    predictions: np.ndarray,
    pos_label: int = 1,
    drop_intermediate: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC curve points (fpr, tpr, thresholds), thresholds strictly decreasing.

    Matches sklearn.metrics.roc_curve (including its drop_intermediate
    collinear-point pruning), plus the (0, 0) origin point sklearn prepends.
    """
    gt = (groundtruth == pos_label).astype(np.float64)
    order = np.argsort(-predictions, kind="stable")
    scores = predictions[order]
    gt = gt[order]

    # indices of the last occurrence of each distinct score
    distinct = np.where(np.diff(scores))[0]
    last_idx = np.concatenate([distinct, [scores.shape[0] - 1]])

    tps = np.cumsum(gt)[last_idx]
    fps = (last_idx + 1) - tps
    thr = scores[last_idx]

    if drop_intermediate and tps.shape[0] > 2:
        keep = np.where(
            np.r_[
                True,
                np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                True,
            ]
        )[0]
        tps, fps, thr = tps[keep], fps[keep], thr[keep]

    n_pos = np.cumsum(gt)[-1]
    n_neg = gt.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("need at least one positive and one negative trial")

    tpr = np.concatenate([[0.0], tps / n_pos])
    fpr = np.concatenate([[0.0], fps / n_neg])
    thresholds = np.concatenate([[np.inf], thr])
    return fpr, tpr, thresholds


def _interp(x: float, xs: np.ndarray, ys: np.ndarray) -> float:
    """Piecewise-linear interpolation where xs is non-decreasing (may repeat).

    Matches scipy.interpolate.interp1d(xs, ys) evaluated the way the
    reference's brentq lands on the EER crossing: at a repeated knot (vertical
    ROC segment) the segment *after* the knot applies.
    """
    i = int(np.searchsorted(xs, x, side="right"))
    i = max(1, min(i, xs.shape[0] - 1))
    x0, x1 = xs[i - 1], xs[i]
    y0, y1 = ys[i - 1], ys[i]
    if x1 == x0:
        return float(y0)
    # the ROC's first threshold knot is +inf (sklearn semantics): any
    # interpolation against it is the finite neighbor, not nan
    if not np.isfinite(y0):
        return float(y1)
    if not np.isfinite(y1):
        return float(y0)
    w = (x - x0) / (x1 - x0)
    return float(y0 + w * (y1 - y0))


def calculate_eer(
    groundtruth_scores: Sequence[int],
    predicted_scores: Sequence[float],
    pos_label: int = 1,
) -> Tuple[float, float]:
    """Equal error rate and its threshold.

    Solves 1 - x - tpr(x) = 0 on the piecewise-linear ROC, like the
    reference's brentq over interp1d (`eval_metrics.py:73-79`), but in closed
    form: walk the ROC segments and solve the linear crossing exactly.
    """
    gt = np.asarray(groundtruth_scores)
    pred = np.asarray(predicted_scores, dtype=np.float64)
    _validate_scores(gt, pred)
    if pos_label not in (0, 1):
        raise ValueError(f"pos_label must be 0 or 1, not {pos_label}")

    fpr, tpr, thresholds = roc_points(gt, pred, pos_label, drop_intermediate=True)

    # g(x) = 1 - x - tpr(x) is non-increasing in x; find the sign change.
    g = 1.0 - fpr - tpr
    # first index where g <= 0
    idx = int(np.argmax(g <= 0))
    if g[idx] > 0:
        # no crossing within the curve: eer at the end point
        eer = float(fpr[-1])
    elif idx == 0:
        eer = float(fpr[0])
    else:
        # crossing inside segment [idx-1, idx]
        x0, x1 = fpr[idx - 1], fpr[idx]
        y0, y1 = tpr[idx - 1], tpr[idx]
        if x1 == x0:
            # vertical segment: crossing at x0 where tpr passes 1 - x0
            eer = float(x0)
        else:
            slope = (y1 - y0) / (x1 - x0)
            # solve 1 - x - (y0 + slope (x - x0)) = 0
            eer = float((1.0 - y0 + slope * x0) / (1.0 + slope))
    thresh = _interp(eer, fpr, thresholds)
    return eer, thresh


def calculate_mdc(
    groundtruth_scores: Sequence[int],
    predicted_scores: Sequence[float],
    c_miss: float = 1.0,
    c_fa: float = 1.0,
    p_target: float = 0.05,
) -> Tuple[float, float]:
    """Minimum detection cost (Kaldi sweep) and its threshold.

    Vectorized equivalent of the reference's `_compute_error_rates` +
    `_compute_min_dfc` (`eval_metrics.py:90-172`): thresholds are the sorted
    scores (ascending, stable), fnr/fpr computed cumulatively, cost minimized
    with first-minimum tie-breaking.
    """
    gt = np.asarray(groundtruth_scores, dtype=np.float64)
    pred = np.asarray(predicted_scores, dtype=np.float64)
    _validate_scores(gt, pred)
    if c_miss < 1:
        raise ValueError(f"c_miss={c_miss} should be >= 1")
    if c_fa < 1:
        raise ValueError(f"c_fa={c_fa} should be >= 1")
    if not (0 <= p_target <= 1):
        raise ValueError(f"p_target={p_target} should be in [0, 1]")

    order = np.argsort(pred, kind="stable")
    thresholds = pred[order]
    gt_sorted = gt[order]

    n_pos = gt_sorted.sum()
    n_neg = gt_sorted.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ZeroDivisionError("need both positive and negative trials")

    fnrs = np.cumsum(gt_sorted) / n_pos
    fprs = 1.0 - np.cumsum(1.0 - gt_sorted) / n_neg

    c_det = c_miss * fnrs * p_target + c_fa * fprs * (1.0 - p_target)
    i = int(np.argmin(c_det))
    c_def = min(c_miss * p_target, c_fa * (1.0 - p_target))
    return float(c_det[i] / c_def), float(thresholds[i])


def _edit_distance(ref: List[str], hyp: List[str]) -> int:
    """Levenshtein distance between two word lists, in two DP rows."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = np.arange(len(hyp) + 1, dtype=np.int64)
    cur = np.zeros(len(hyp) + 1, dtype=np.int64)
    hyp_arr = np.array(hyp)
    for i, r in enumerate(ref, start=1):
        cur[0] = i
        # substitution or deletion at once; insertion runs along the row
        np.minimum(prev[:-1] + (hyp_arr != r), prev[1:] + 1, out=cur[1:])
        for j in range(1, len(hyp) + 1):
            cur[j] = min(cur[j], cur[j - 1] + 1)
        prev, cur = cur, prev
    return int(prev[-1])


def calculate_wer(transcriptions: Sequence[str], ground_truths: Sequence[str]) -> float:
    """Corpus word error rate: the word edits of every hypothesis summed,
    over the words of every reference summed (a single string is one
    utterance)."""
    if isinstance(transcriptions, str):
        transcriptions = [transcriptions]
    if isinstance(ground_truths, str):
        ground_truths = [ground_truths]
    if len(transcriptions) != len(ground_truths):
        raise ValueError("transcriptions and ground_truths length mismatch")
    edits = words = 0
    for hyp, ref in zip(transcriptions, ground_truths):
        edits += _edit_distance(ref.split(), hyp.split())
        words += len(ref.split())
    if words == 0:
        raise ValueError("empty ground truth")
    return edits / words
