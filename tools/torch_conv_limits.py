"""Which part of the bf16 fused-conv kernel bounds it (PyTorch port, one
NVIDIA card).

    python3 tools/torch_conv_limits.py

Times ``csrc/conv_encoder.cu`` as built and variants of it that each leave
one part of the work out, over conv layers 1-6 at the LARGE (B=48, bias +
LN) and BASE (B=66) training shapes in bf16, each variant compiled into a
temporary directory and timed in turns (as built first and last). The
variants compute wrong outputs; only their times are read:

- ``no_w_loads``: the producer loads A only; the products read whatever W
  the ring holds (the W stream from L2 left out);
- ``no_products``: no wgmma (the tensor cores left out);
- ``a_only``: both of the above: the A loads, the barriers and the
  epilogue;
- ``a_only_ring12``: ``a_only`` with a 12-deep ring of A-only stages (is
  the A stream latency-bound at the ring's depth?);
- ``no_ln_gelu``: the epilogue without LayerNorm and GELU.

Prints one JSON line per variant and shape (device ms per layer stack,
CUDA events), with the A bytes each stack's blocks load and the rate they
reach in ``a_only``. Needs ``nvcc`` and one card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from w2v2_speaker_tpu_torch.models.wav2vec2 import BASE_CONFIG, LARGE_CONFIG  # noqa: E402
from w2v2_speaker_tpu_torch.ops import _build  # noqa: E402
from w2v2_speaker_tpu_torch.ops import conv_encoder as ce  # noqa: E402

NO_W = [
    ("        mbar_arrive_expect_tx(&full[stage], S::kStageBytes);",
     "        mbar_arrive_expect_tx(&full[stage], S::kABytes);"),
    ("        tma_load_2d(w_s, &maps.w, &full[stage], kk, 0);\n"
     "        tma_load_2d(w_s + kN * kBK * 2, &maps.w, &full[stage], kk, kN);\n", ""),
]
NO_MMA = [
    ("      for (int k16 = 0; k16 < kBK / 16; ++k16) wgmma_ss<kN>(acc, da + 2 * k16, db + 2 * k16, 1);\n",
     "      if (da == db) wgmma_ss<kN>(acc, da, db, 1);\n"),
]
RING12 = [
    ("  static constexpr int kStageBytes = kABytes + kWBytes;", "  static constexpr int kStageBytes = kABytes;"),
    ("  static constexpr int kStages = kStageBudget / kStageBytes < 6 ? kStageBudget / kStageBytes : 6;",
     "  static constexpr int kStages = 12;"),
]
VARIANTS = {  # name: [(old, new)], each old text occurring once
    "no_w_loads": NO_W,
    "no_products": NO_MMA,
    "a_only": NO_W + NO_MMA,
    "a_only_ring12": NO_W + NO_MMA + RING12,
    "no_ln_gelu": [
        ("    if (p.ln_scale) {\n      const float inv_c", "    if (false) {\n      const float inv_c"),
        ("          if (p.gelu) {\n            v0 = gelu_exact(v0);",
         "          if (false) {\n            v0 = gelu_exact(v0);"),
    ],
}
A_STEP_BYTES = 64 * 64 * 2  # one A box: 64 frames x 64 channels of bf16


def build_variant(name: str, out_dir: pathlib.Path):
    src = (_build.CSRC_DIR / "conv_encoder.cu").read_text()
    for old, new in VARIANTS[name]:
        assert src.count(old) == 1, f"{name}: {old!r}"
        src = src.replace(old, new)
    path = out_dir / f"conv_{name}.cu"
    path.write_text(src)
    lib = out_dir / f"libconv_{name}.so"
    _build.compile_library(path, lib)
    return ce.bind(ctypes.CDLL(str(lib)))


def a_bytes(layers) -> int:
    """Bytes of A the blocks load: 64-frame tiles x k*C/64 steps x one box."""
    total = 0
    for x, w, *_ in layers:
        b, t_in, c = x.shape
        k = w.shape[0]
        tiles = -(-((t_in - k) // 2 + 1) // 64)
        total += b * tiles * (k * c // 64) * A_STEP_BYTES
    return total


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_limits: needs a CUDA card")
    card = chip_smoke.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = {"large_train_3s": chip_smoke.conv_stack_inputs(LARGE_CONFIG, chip_smoke.LARGE_BATCH, torch.bfloat16,
                                                          gen),
            "base_train_3s": chip_smoke.conv_stack_inputs(BASE_CONFIG, 66, torch.bfloat16, gen)}
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"as_built": ce._kernel()}
        fns.update({name: build_variant(name, pathlib.Path(tmp)) for name in VARIANTS})
        order = list(fns) + ["as_built"]
        for shape, layers in sets.items():
            times = {}
            for name in order:
                ce._fn = fns[name]
                ms = chip_smoke.cuda_ms(lambda: [ce.strided_conv_fused(*layer) for layer in layers], 10)
                times.setdefault(name, []).append(ms)
            nbytes = a_bytes(layers)
            for name, readings in times.items():
                row = {"shape": shape, "variant": name, "ms": readings, "a_bytes": nbytes,
                       "a_tb_per_s": nbytes / (readings[0] * 1e-3) / 1e12, "card": card}
                print(json.dumps(row), flush=True)
        ce._fn = fns["as_built"]


if __name__ == "__main__":
    main()
