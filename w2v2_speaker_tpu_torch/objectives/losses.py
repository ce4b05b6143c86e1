"""Training losses.

Counterpart of ``w2v2_speaker_tpu/objectives/losses.py``: ``cross_entropy``
(:43), ``binary_cross_entropy`` (:63), ``aam_margin_logits`` (:74),
``mine_triplets`` (:104), ``triplet_loss`` (:136),
``triplet_cross_entropy`` (:165) and ``ctc_loss`` (:176).

``mine_triplets`` draws on the labels' device: for each anchor a uniform
positive (same label, another row) and a uniform negative (another label),
each the argmax of Gumbel noise over the valid candidates, with no loop
over rows and no host sync. Its noise comes from a generator on that
device seeded with one draw of the step's generator (a CPU one in
training). The JAX package draws with ``jax.random.gumbel``, so the picks
are not equal draw for draw across the packages; the losses are, given the
same indices.

``ctc_loss`` takes each row's loss from ``ops/ctc.py`` (a hand-written
forward-backward on the card, in place of ``F.ctc_loss``, whose CUDA
backward sums with atomics) and keeps the ``zero_infinity`` semantics that
the JAX function's docstring and the original PyTorch reference promise: a
row whose frames are too few for its label scores 0 and gives no gradient. The JAX package
computes CTC with optax, whose finite ``log_epsilon`` (-1e5) scores such a
row ~1e5 instead, so its ``isfinite`` test (:199) never fires and the row
adds ~1e5 / L to the mean: the one deliberate divergence of the two, pinned
by ``tests/test_torch_speech.py``. Feasible rows agree.

In a data-parallel microbatch (``parallel.mesh.active_rows``) every mean
runs over the global microbatch (``global_mean``: the padding-weighted ones
divide by the global weight sum), and the triplet losses mine and score
the all-gathered embeddings with the shared generator, so each rank
computes the global loss, as the JAX package does under GSPMD.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.ctc import ctc_loss_rows
from ..parallel.mesh import gather_rows, global_mean

__all__ = [
    "aam_margin_logits", "binary_cross_entropy", "cross_entropy", "ctc_loss", "frame_lengths", "mine_triplets",
    "triplet_cross_entropy", "triplet_loss",
]


def cross_entropy(
    logits: torch.Tensor,  # [B, C]
    labels: torch.Tensor,  # [B] int
    weights: Optional[torch.Tensor] = None,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE over the batch, softmax predictions without gradient).

    Optional per-row ``weights`` (0 for padding rows, 1 otherwise) turn the
    mean into a weighted mean over max(sum of weights, 1)."""
    ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return global_mean(ce, weights), torch.softmax(logits.detach().float(), dim=-1)


def binary_cross_entropy(
    logits: torch.Tensor,  # [B] or [B, 1]
    labels: torch.Tensor,  # [B] 0 / 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean BCE-with-logits in float32, sigmoid predictions without
    gradient)."""
    logits = logits.reshape(-1).float()
    bce = F.binary_cross_entropy_with_logits(logits, labels.reshape(-1).float(), reduction="none")
    return global_mean(bce), torch.sigmoid(logits.detach())


def aam_margin_logits(
    cosine: torch.Tensor,  # [B, C] cos(theta)
    labels: torch.Tensor,  # [B] int
    margin: float = 0.2,
    scale: float = 30.0,
    easy_margin: bool = False,
) -> torch.Tensor:
    """The target class's cosine replaced by cos(theta + m) inside the
    monotonic region (cos theta > cos(pi - m)) and by cos theta -
    m sin(pi - m) outside it (by cos theta where cos theta <= 0 with
    ``easy_margin``); every logit times ``scale``."""
    sine = (1.0 - cosine * cosine).clamp(0.0, 1.0).sqrt()
    phi = cosine * math.cos(margin) - sine * math.sin(margin)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine - math.cos(math.pi - margin) > 0, phi,
                          cosine - math.sin(math.pi - margin) * margin)
    one_hot = F.one_hot(labels.long(), cosine.shape[-1]).to(cosine.dtype)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * scale


def mine_triplets(labels: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positive index [B], negative index [B]) per anchor: uniform over the
    rows with the anchor's label but another row, and over the rows with
    another label. An anchor without a valid positive or negative gets an
    arbitrary index (``triplet_loss`` leaves it out of the mean)."""
    b, dev = labels.shape[0], labels.device
    if generator is not None and generator.device.type != dev.type:
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        generator = torch.Generator(device=dev).manual_seed(seed)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(b, dtype=torch.bool, device=dev)
    neg_inf = torch.finfo(torch.float32).min
    picks = []
    for valid in (same & ~eye, ~same):
        u = torch.rand((b, b), generator=generator, device=dev).clamp_min(1e-20)
        gumbel = -torch.log((-torch.log(u)).clamp_min(1e-20))
        picks.append(torch.where(valid, gumbel, neg_inf).argmax(dim=1))
    return picks[0], picks[1]


def _triplet_valid(labels: torch.Tensor) -> torch.Tensor:
    """[B] float: 1 for an anchor with a positive and a negative in the batch."""
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return ((same & ~eye).any(dim=1) & (~same).any(dim=1)).float()


def triplet_loss(
    embeddings: torch.Tensor,  # [B, D]
    labels: torch.Tensor,  # [B] int
    generator: Optional[torch.Generator] = None,
    margin: float = 1.0,
) -> torch.Tensor:
    """mean(max(d(a, p) - d(a, n) + margin, 0)) over the anchors that have
    a positive and a negative, d(a, b) = sqrt(sum((a - b + 1e-6)^2)) (torch
    ``triplet_margin_loss``'s, p=2, eps=1e-6), over ``mine_triplets``'
    picks; over the global microbatch's rows in data parallelism."""
    emb, labels = gather_rows(embeddings.float()), gather_rows(labels)
    pos_idx, neg_idx = mine_triplets(labels, generator)

    def dist(a, b):
        return ((a - b + 1e-6) ** 2).sum(-1).sqrt()

    per_anchor = (dist(emb, emb[pos_idx]) - dist(emb, emb[neg_idx]) + margin).clamp_min(0.0)
    valid = _triplet_valid(labels)
    return (per_anchor * valid).sum() / valid.sum().clamp_min(1.0)


def triplet_cross_entropy(
    embeddings: torch.Tensor,
    logits: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    c_ce: float = 1.0,
    c_triplet: float = 1.0,
    margin: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_ce x CE + c_triplet x the triplet loss, softmax predictions)."""
    ce, preds = cross_entropy(logits, labels)
    return c_ce * ce + c_triplet * triplet_loss(embeddings, labels, generator, margin), preds


def frame_lengths(logits: torch.Tensor, frame_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The valid frames [B] int32 of frame logits [B, T, ...]: the sum of
    the model's ``frame_mask`` [B, T], or T in every row when it is None."""
    if frame_mask is None:
        return torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int32, device=logits.device)
    return frame_mask.sum(-1).to(torch.int32)


def ctc_loss(
    logits: torch.Tensor,  # [B, T, V]
    logit_lengths: torch.Tensor,  # [B]
    labels: torch.Tensor,  # [B, S], 0-padded
    label_lengths: torch.Tensor,  # [B]
    blank_id: int = 0,
) -> torch.Tensor:
    """Mean over rows with a non-empty label of each row's CTC loss (float32
    log-softmax, infeasible rows 0) divided by its label length; rows with
    an empty label (padding rows) are left out of the mean. Each row's loss
    is ``ops.ctc``'s: the hand-written kernels on the card (no atomics, so
    deterministic), their plain versions on the CPU."""
    per_seq = ctc_loss_rows(logits, logit_lengths, labels, label_lengths, blank_id)
    valid = (label_lengths > 0).to(per_seq.dtype)
    return global_mean(per_seq / label_lengths.clamp_min(1).to(per_seq.dtype), valid)
