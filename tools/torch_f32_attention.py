"""The float32 attention backward kernels against their first version and
SDPA's float32 backward (PyTorch port, one NVIDIA card).

    python3 tools/torch_f32_attention.py [--first DIR] [--variants]

At ``chip_smoke.ATTN_SHAPES`` in float32, at dropout rates 0 and 0.1, the
dq and dk/dv kernels as built are held against their plain versions
(``chip_smoke.attention_pair_errors``: ``fa.kernel_tolerance``, rows past
the length exactly 0, two launches bit-equal, and each output's distance
from ``fa.attention_bwd_float64`` within ``chip_smoke.ATTN_F64_FACTOR``
times the plain version's) and timed (CUDA events) beside SDPA's float32
backward (``chip_smoke.backward_ms``), the 3xTF32 bound and the SIMT time.
With ``--first DIR``, ``DIR/flash_attention_bwd.cu`` (an earlier source
and the headers it includes, e.g. ``git archive <commit>
w2v2_speaker_tpu_torch/csrc`` unpacked into a directory ``.gitignore``
lists; the card machine has no git) is built behind the same C interface,
held against the plain versions too, and timed in turns with the build
(first, built, built, first). With ``--variants``, first each text-edit
variant of ``VARIANTS``, held to the same limits and timed in turns with
the build. Then the library kernels that ran, by
name and device time, from one profiled call each: SDPA's float32
forward and backward at BASE's training shape, rate 0.1, and the float32
conv route (``F.conv1d`` + ``F.layer_norm`` + ``F.gelu`` over LARGE's conv
layers 1-6, cuDNN's TF32 off). Prints the ``nvcc`` report of the build and
one JSON line per reading, and fails at the end if the build missed a
limit. Needs ``nvcc`` and one card (~3 min).
"""

from __future__ import annotations

import ctypes
import itertools
import json
import pathlib
import sys
import tempfile

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from w2v2_speaker_tpu_torch.device import set_float32_precision  # noqa: E402
from w2v2_speaker_tpu_torch.models.wav2vec2 import LARGE_CONFIG  # noqa: E402
from w2v2_speaker_tpu_torch.ops import _build  # noqa: E402
from w2v2_speaker_tpu_torch.ops import flash_attention as fa  # noqa: E402

REPS = 20
# --variants: text edits of csrc/flash_attention_bwd.cu (each old text
# occurring), timed in turns with the build (built, variant, variant, built)
# at the 3 s and 64 s shapes, rates 0 and 0.1, and held to the same limits
_FENCE = '    asm volatile("" : "+l"(base));  // derived here, not held across the loop\n'


def _descs(names_tiles) -> str:
    """Descriptor definitions from the opaque ``base`` (tile i at base + i
    KB)."""
    return "".join(f"    const uint64_t {n} = base + {i} * (kF32Tile >> 4);\n" for n, i in names_tiles)


_DQ_DESCS = """  const uint64_t qh = desc_k_major(qs_hi), ql = desc_k_major(qs_lo);
  const uint64_t dh = desc_k_major(do_hi), dl = desc_k_major(do_lo);
  const uint64_t kh = desc_k_major(k_hi), kl = desc_k_major(k_hi + kF32Tile);
  const uint64_t vh = desc_k_major(k_hi + 2 * kF32Tile), vl = desc_k_major(k_hi + 3 * kF32Tile);
  const uint64_t kth = desc_k_major(k_hi + 4 * kF32Tile), ktl = desc_k_major(k_hi + 5 * kF32Tile);
"""
_DKV_DESCS = """  const uint64_t kh = desc_k_major(k_hi), kl = desc_k_major(k_hi + kF32Tile);
  const uint64_t vh = desc_k_major(k_hi + 2 * kF32Tile), vl = desc_k_major(k_hi + 3 * kF32Tile);
  const uint64_t qh = desc_k_major(qs_hi), ql = desc_k_major(qs_hi + kF32Tile);
  const uint64_t dh = desc_k_major(qs_hi + 2 * kF32Tile), dl = desc_k_major(qs_hi + 3 * kF32Tile);
  const uint64_t qth = desc_k_major(qs_hi + 4 * kF32Tile), qtl = desc_k_major(qs_hi + 5 * kF32Tile);
  const uint64_t dth = desc_k_major(qs_hi + 6 * kF32Tile), dtl = desc_k_major(qs_hi + 7 * kF32Tile);
"""
_BASE = "  uint64_t base = desc_k_major(smem);\n"
VARIANTS = {
    # the products' descriptors derived from an opaque base at each
    # product instead of held in registers across the loop (12 64-bit
    # values in dk/dv, 10 in dq)
    "desc_at_products": [
        (_DQ_DESCS, _BASE), (_DKV_DESCS, _BASE),
        ("    float s[32], dp[32];\n    wgmma_fence();\n",
         _FENCE + _descs([("qh", 0), ("ql", 1), ("dh", 2), ("dl", 3), ("kh", 6), ("kl", 7), ("vh", 8), ("vl", 9)])
         + "    float s[32], dp[32];\n    wgmma_fence();\n"),
        ("    product_rs(part, zh, zl, kth, ktl);\n",
         _FENCE + _descs([("kth", 10), ("ktl", 11)]) + "    product_rs(part, zh, zl, kth, ktl);\n"),
        ("    float st[32], dpt[32];\n    wgmma_fence();\n#pragma unroll\n    for (int k8 = 0; k8 < 8; ++k8) "
         "small_ss(st,",
         _FENCE + _descs([("kh", 0), ("kl", 1), ("vh", 2), ("vl", 3), ("qh", 6), ("ql", 7), ("dh", 8), ("dl", 9)])
         + "    float st[32], dpt[32];\n    wgmma_fence();\n#pragma unroll\n    for (int k8 = 0; k8 < 8; ++k8) "
         "small_ss(st,"),
        ("    product_rs(part, ah, al, dth, dtl);\n",
         _FENCE + _descs([("dth", 12), ("dtl", 13)]) + "    product_rs(part, ah, al, dth, dtl);\n"),
        ("    product_rs(part, ah, al, qth, qtl);\n",
         _FENCE + _descs([("qth", 10), ("qtl", 11)]) + "    product_rs(part, ah, al, qth, qtl);\n"),
    ],
    # the splits under a product all 8 chunks at once (as the splits
    # outside the products)
    "split_unroll_8": [("constexpr int kSplitUnderProduct = 2;", "constexpr int kSplitUnderProduct = 8;")],
}


def library_kernels(label: str, fn, top: int = 6) -> None:
    """The device kernels of one profiled ``fn()`` (after one warm call),
    by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    print(json.dumps({"library": label, "kernels": [
        {"name": name, "us": us} for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]}),
        flush=True)


def print_ptxas(report: str, label: str) -> None:
    """The ``nvcc`` report's lines on the kernels, registers, spills and
    warnings."""
    for line in report.splitlines():
        if any(w in line for w in ("_kernel", "registers", "spill", "warning")):
            print("ptxas", label, line.strip(), flush=True)


def pair_shares(args, lens) -> dict:
    """dq, dk and dv of the kernels ``fa`` holds now against the plain
    version: each one's share of its limit, zeros past the length."""
    got = (fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args))
    return {grad: chip_smoke.attention_error(g, w, lens, backward=True)[1:]
            for grad, g, w in zip(("dq", "dk", "dv"), got, fa.flash_attention_bwd_plain(*args))}


def pair_ms(fns, args) -> tuple:
    """(dq ms, dk/dv ms) of the backward entry points ``fns`` on ``args``."""
    fa._bwd_fns = fns
    return (chip_smoke.cuda_ms(lambda: fa.flash_attention_bwd_dq(*args), REPS),
            chip_smoke.cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args), REPS))


def variant_readings(built, tmp: pathlib.Path, card: str) -> list:
    """Each of ``VARIANTS`` built and held to the limits, then timed in
    turns with the build; returns the limits it missed."""
    failed = []
    src = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) >= 1, f"{name}: {old!r}"
            text = text.replace(old, new)
        path = tmp / f"{name}.cu"
        path.write_text(text)
        lib = tmp / f"lib{name}.so"
        print_ptxas(_build.compile_library(path, lib), name)
        variant = fa.bind_bwd(ctypes.CDLL(str(lib)))
        gen = torch.Generator(device="cuda").manual_seed(1)
        for (shape, b, t, lengths), rate in itertools.product(chip_smoke.ATTN_SHAPES[::2], chip_smoke.RATES):
            q, k, v, lens = chip_smoke.attention_inputs(b, t, lengths, torch.float32, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda")
            fa._bwd_fns = variant
            seed = chip_smoke.DROPOUT_SEED if rate > 0 else None
            errors, args, _ = chip_smoke.attention_pair_errors(q, k, v, lens, rate, seed, do)
            failed += [f"variant {name} {shape} rate {rate} {out}: {share:.3f} of the limit, zeros {zeros}"
                       for out, (_, share, zeros) in errors.items() if not (share <= 1 and zeros)]
            turns = [pair_ms(fns, args) for fns in (built, variant, variant, built)]
            fa._bwd_fns = built
            print(json.dumps({"variant": name, "shape": shape, "rate": rate, "card": card,
                              "shares": {out: e[1] for out, e in errors.items()},
                              "built_ms": [sum(x) / 2 for x in zip(turns[0], turns[3])],
                              "variant_ms": [sum(x) / 2 for x in zip(turns[1], turns[2])],
                              "turns_ms": turns}), flush=True)
    return failed


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_attention: needs a CUDA card")
    card = chip_smoke.card_line()
    print(card, flush=True)
    set_float32_precision()
    print_ptxas(_build.build_all(["flash_attention_bwd"])["flash_attention_bwd"], "built")
    built = fa._bwd_kernels()
    first, failed = None, []
    argv = sys.argv[1:]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if "--variants" in argv:
            failed += variant_readings(built, tmp, card)
        if "--first" in argv:
            lib = tmp / "libfirst_bwd.so"
            print_ptxas(_build.compile_library(
                pathlib.Path(argv[argv.index("--first") + 1]) / "flash_attention_bwd.cu", lib), "first")
            first = fa.bind_bwd(ctypes.CDLL(str(lib)))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, b, t, lengths in chip_smoke.ATTN_SHAPES:
            for rate in chip_smoke.RATES:
                q, k, v, lens = chip_smoke.attention_inputs(b, t, lengths, torch.float32, gen)
                do = torch.randn(q.shape, generator=gen, device="cuda")
                seed = chip_smoke.DROPOUT_SEED if rate > 0 else None
                errors, args, _ = chip_smoke.attention_pair_errors(q, k, v, lens, rate, seed, do)
                failed += [f"{name} rate {rate} {out}: err {err}, {share:.3f} of the limit, zeros {zeros}"
                           for out, (err, share, zeros) in errors.items() if not (share <= 1 and zeros)]
                row = {"shape": name, "rate": rate, "B": b, "T": t, "card": card,
                       "built_shares": {out: e[1] for out, e in errors.items()}}
                versions = {"built": built} if first is None else {"first": first, "built": built}
                if first is not None:
                    fa._bwd_fns = first
                    row["first_shares"] = pair_shares(args, lens)
                times = {label: {"dq": [], "dkv": []} for label in versions}
                for label in (["first", "built", "built", "first"] if first is not None else ["built"]):
                    dq_ms, dkv_ms = pair_ms(versions[label], args)
                    times[label]["dq"].append(dq_ms)
                    times[label]["dkv"].append(dkv_ms)
                fa._bwd_fns = built
                for label, kernels in times.items():
                    row[f"{label}_ms"] = {kernel: sum(ms) / len(ms) for kernel, ms in kernels.items()}
                    row[f"{label}_ms"]["pair"] = row[f"{label}_ms"]["dq"] + row[f"{label}_ms"]["dkv"]
                    row[f"{label}_ms"]["turns"] = kernels
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
                mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
                out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate)
                row["sdpa_bwd_ms"] = chip_smoke.backward_ms(out, (qt, kt, vt), do.transpose(1, 2), 10)
                del out
                for kernel in ("dq", "dkv"):
                    bound, by = chip_smoke.attention_bound(kernel, lengths, t, torch.float32)
                    row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = bound, by
                    row[f"{kernel}_simt_ms"] = 1e3 * chip_smoke.attention_flops(kernel, lengths) / \
                        chip_smoke.PEAK_OPS[torch.float32]
                print(json.dumps(row), flush=True)
    fa._bwd_fns = None

    b, t = 66, 149
    q, k, v, lens = chip_smoke.attention_inputs(b, t, [t] * b, torch.float32, gen)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    grad = torch.randn(qt.shape, generator=gen, device="cuda")

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=0.1)

    with torch.no_grad():
        library_kernels("sdpa_f32_forward train_3s rate 0.1", sdpa)
    out = sdpa()
    library_kernels("sdpa_f32_backward train_3s rate 0.1",
                    lambda: torch.autograd.grad(out, (qt, kt, vt), grad, retain_graph=True))
    layers = chip_smoke.conv_stack_inputs(LARGE_CONFIG, chip_smoke.LARGE_BATCH, torch.float32, gen)
    library_kernels("conv_f32_route large_train_3s", chip_smoke.conv_library_call(layers))
    assert not failed, "the built kernels missed a limit:\n" + "\n".join(failed)


if __name__ == "__main__":
    main()
