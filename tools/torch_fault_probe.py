"""Planted faults against the limits of ``chip_smoke.py`` (PyTorch port, one
NVIDIA card).

    python3 tools/torch_fault_probe.py

Reads each limit twice: on the correct code (over several seeds), and on a
deliberately wrong copy of it. A limit is worth keeping only where the
first reading sits well under it and the second well over it.

- Kernel vs plain version (``chip_smoke.attention_error``, the share of
  ``fa.kernel_tolerance`` used), at the shapes of ``chip_smoke.ATTN_SHAPES``,
  in float32 and bfloat16, for the kernel as built and for two mutants of
  ``csrc/flash_attention_fwd.cu`` compiled into a temporary directory: one
  that does not mask the boundary K/V tile, one that does not rescale the
  accumulator when the running max grows.
- Padding invariance of bucketed serving (``chip_smoke.padding_ratio``), for
  the port as it is, with two embeddings handed back swapped (the closest
  pair), and with attention that ignores the key lengths.

Prints one JSON line per reading. Needs ``nvcc`` and one card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from w2v2_speaker_tpu_torch.entry import entry  # noqa: E402
from w2v2_speaker_tpu_torch.models import wav2vec2 as tw  # noqa: E402
from w2v2_speaker_tpu_torch.ops import _build  # noqa: E402
from w2v2_speaker_tpu_torch.ops import flash_attention as fa  # noqa: E402
from w2v2_speaker_tpu_torch.runtime.predict import extract_embeddings  # noqa: E402

SEEDS = (0, 1, 2, 3)
# (old, new) text replacements, each of which must match exactly once
MUTANTS = {
    "no_boundary_mask": [
        ("    if (k0 + kBlockK > len) {  // boundary tile: mask keys >= len\n",
         "    if (false) {\n"),
        ("s[jj] = j0 + jj < n_valid ? dot : -INFINITY;", "s[jj] = dot;"),
    ],
    "no_acc_rescale": [
        ("      acc[n][0] *= alpha[0];\n      acc[n][1] *= alpha[0];\n"
         "      acc[n][2] *= alpha[1];\n      acc[n][3] *= alpha[1];\n", ""),
        ("for (int d = 0; d < kD; ++d) acc[d] *= alpha;", ""),
    ],
}


def build_mutant(name: str, edits, out_dir: pathlib.Path):
    src = (_build.CSRC_DIR / "flash_attention_fwd.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, f"{name}: {old!r} does not match once"
        src = src.replace(old, new)
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    lib = out_dir / f"lib{name}.so"
    _build.compile_library(path, lib)
    return fa.bind(ctypes.CDLL(str(lib)))


def kernel_readings(variant: str, seeds) -> None:
    for name, b, t, lengths in chip_smoke.ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            shares, errs, zeros = [], [], True
            for seed in seeds:
                gen = torch.Generator(device="cuda").manual_seed(seed)
                q, k, v, lens = chip_smoke.attention_inputs(b, t, lengths, dtype, gen)
                got = fa.flash_attention(q, k, v, lens)
                want = fa.flash_attention_plain(q, k, v, lens)
                err, share, ok = chip_smoke.attention_error(got, want, lens)
                errs.append(err)
                shares.append(share)
                zeros &= ok
            print(json.dumps({
                "limit": "kernel", "variant": variant, "shape": name,
                "dtype": str(dtype).removeprefix("torch."), "seeds": len(seeds),
                "max_abs_err": max(errs), "limit_share": max(shares),
                "padded_rows_zero": zeros,
            }), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_fault_probe: needs a CUDA card")
    print(chip_smoke.card_line(), flush=True)
    _build.build("flash_attention_fwd")
    kernel_readings("as_built", SEEDS)
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in MUTANTS.items():
            fa._fwd_fn = build_mutant(name, edits, pathlib.Path(tmp))
            kernel_readings(name, SEEDS[:1])
    fa._fwd_fn = None  # the kernel as built again

    forward, (model, _) = entry()
    samples = chip_smoke.serving_samples(np.random.default_rng(0))
    alone = chip_smoke.unpadded_embeddings(forward, model, samples)
    served = {
        e.sample_id: e.embedding
        for e in extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)
    }
    keys = sorted(alone)
    a = np.stack([alone[key] for key in keys])
    apart = np.linalg.norm(a[:, None] - a[None], axis=-1) + np.diag(np.full(len(keys), np.inf))
    i, j = np.unravel_index(np.argmin(apart), apart.shape)
    swapped = dict(served, **{keys[i]: served[keys[j]], keys[j]: served[keys[i]]})

    def keys_unmasked(q, k, v, lengths):
        return fa.flash_attention(q, k, v, None)

    tw.flash_attention = keys_unmasked
    leaked = {
        e.sample_id: e.embedding
        for e in extract_embeddings(model, samples, pad_to_multiple=16000, batch_size=4)
    }
    tw.flash_attention = fa.flash_attention
    for variant, got in (("as_built", served), ("swapped_rows", swapped),
                         ("keys_unmasked", leaked)):
        print(json.dumps({
            "limit": "padding", "variant": variant,
            "distance_ratio": chip_smoke.padding_ratio(got, alone),
            "min_cosine": float(min(chip_smoke.cosine(got[key], alone[key]) for key in keys)),
        }), flush=True)


if __name__ == "__main__":
    main()
