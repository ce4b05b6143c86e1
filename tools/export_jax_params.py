"""Export the params of a JAX-package checkpoint as an ``.npz`` for the
PyTorch port.

    python tools/export_jax_params.py <checkpoint> <out.npz>

``<checkpoint>`` is what ``load_network_from_checkpoint`` names in
``predict.py`` / ``run.py``: a weights-only save
(``w2v2_speaker_tpu.train.checkpoint.save_params``) or a checkpoint
manager's entry (``logs/<exp>/checkpoints/best`` resolves to its best
entry, as ``resolve_checkpoint_path`` does). It is restored with orbax as
saved (a raw restore, which needs no template), and its ``params`` tree is
written with ``numpy.savez``, one array per leaf, under its ``/``-joined
path in the tree (``wav2vec2/encoder/layers/block/attention/qkv_proj/kernel``).
A checkpoint manager's entry also holds the model state; its
``batch_stats`` leaves (the running statistics of ``attentive`` pooling's
BatchNorm) are written under ``batch_stats/`` followed by their path
(``batch_stats/stat_pooling/attn_bn/mean``).
The port reads the file with
``w2v2_speaker_tpu_torch.train.checkpoint.load_params``
(``load_network_from_checkpoint=<out.npz>``). Needs JAX and orbax, which
the port itself never imports.
"""

from __future__ import annotations

import pathlib
import sys
from typing import Dict, Mapping

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def export(checkpoint, out) -> Dict[str, np.ndarray]:
    """Write the ``.npz`` of ``checkpoint``'s params (and batch_stats) to
    ``out``; returns the flattened arrays."""
    import orbax.checkpoint as ocp

    from w2v2_speaker_tpu.train.checkpoint import resolve_checkpoint_path

    path = resolve_checkpoint_path(checkpoint).absolute()
    restored = ocp.StandardCheckpointer().restore(path)
    flat = flatten(restored["params"])
    batch_stats = (restored.get("model_state") or {}).get("batch_stats")
    if batch_stats:
        flat.update(flatten(batch_stats, "batch_stats/"))
    np.savez(out, **flat)
    return flat


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        raise SystemExit(__doc__)
    flat = export(args[0], args[1])
    print(f"wrote {len(flat)} arrays ({sum(a.size for a in flat.values())} values) to {args[1]}")


if __name__ == "__main__":
    main()
