"""The bf16 flash-attention forward's and dq kernel's geometry and launch
settings, timed (PyTorch port, one NVIDIA card).

    python3 tools/torch_attention_variants.py

Times the kernels as built and variants of them, each compiled into a
temporary directory from a text edit of its source and timed in turns (as
built first and last). Forward (``csrc/flash_attention_fwd.cu``):

- ``keys_128``: K/V tiles of 128 keys (``wgmma`` m64n128k16 for S; a 3 s
  clip's 149 keys in two tiles instead of three);
- ``stages_3``: a ring of three K/V tiles (two in flight while one
  computes);
- ``warpgroups_2``: two warpgroups over 128 q rows sharing each K/V tile;
- ``whole_clip``: three warpgroups over 192 q rows with a three-tile ring,
  so a 3 s clip's (batch, head) is one block that copies all its keys at
  once and reads them from memory once;
- ``max_carveout``: the launch asks for the largest shared-memory
  carveout of the SM instead of the CUDA default.

dq (``csrc/flash_attention_bwd.cu``): ``dq_max_carveout``, the same
launch setting.

At the LARGE training shape (B=48, T=149, H=16) and a 64 s pair (B=2,
T=3200, lengths 3200 and 2911, H=12), bf16, at dropout rates 0
(inference) and 0.1 (training, with the LSE). Each variant is also held
against the plain version (share of ``fa.kernel_tolerance``, rows past
the length exactly 0), so a faster variant that is wrong shows. Prints
one JSON line per kernel, shape, rate and variant (device ms per call,
CUDA events), with SDPA's forward or backward on the same inputs. Needs
``nvcc`` and one card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import sys
import tempfile

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from w2v2_speaker_tpu_torch.ops import _build  # noqa: E402
from w2v2_speaker_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _constant(name: str, value: int):
    return (f"constexpr int {name} = ", f"constexpr int {name} = {value};  //")


def _max_carveout(smem: str):
    attr = f"cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});"
    return (attr, attr + "\n    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,"
                         " cudaSharedmemCarveoutMaxShared);")


FWD, BWD = "flash_attention_fwd", "flash_attention_bwd"
VARIANTS = {  # name: (source, [(old, new)]), each old text occurring once
    "keys_128": (FWD, [_constant("kFwdBlockN", 128)]),
    "stages_3": (FWD, [_constant("kFwdStages", 3)]),
    "warpgroups_2": (FWD, [_constant("kFwdWarpgroups", 2)]),
    "whole_clip": (FWD, [_constant("kFwdWarpgroups", 3), _constant("kFwdStages", 3)]),
    "max_carveout": (FWD, [_max_carveout("kFwdSmem")]),
    "dq_max_carveout": (BWD, [_max_carveout("kDqSmem")]),
}
SHAPES = (  # (name, B, T, lengths, H)
    ("large_train_3s", chip_smoke.LARGE_BATCH, 149, [149] * chip_smoke.LARGE_BATCH, chip_smoke.H_LARGE),
    ("long_64s", 2, 3200, [3200, 2911], chip_smoke.H),
)


def variant_source(name: str) -> str:
    source, edits = VARIANTS[name]
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, f"{name}: {old!r}"
        src = src.replace(old, new)
    return src


def build_variant(name: str, out_dir: pathlib.Path):
    path = out_dir / f"{name}.cu"
    path.write_text(variant_source(name))
    lib = out_dir / f"lib{name}.so"
    _build.compile_library(path, lib)
    bind = fa.bind if VARIANTS[name][0] == FWD else fa.bind_bwd
    return bind(ctypes.CDLL(str(lib)))


def in_turns(fns: dict, install, run, check) -> tuple:
    """({name: [ms, ...]}, {name: limit share}) with each of ``fns``
    installed by ``install`` in turn, the first again at the end."""
    times, shares = {}, {}
    for name in list(fns) + [next(iter(fns))]:
        install(fns[name])
        shares[name] = check()
        times.setdefault(name, []).append(chip_smoke.cuda_ms(run, 20))
    return times, shares


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_variants: needs a CUDA card")
    card = chip_smoke.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        built = {name: build_variant(name, pathlib.Path(tmp)) for name in VARIANTS}
        fwd_fns = {"as_built": fa._kernel(), **{n: f for n, f in built.items() if VARIANTS[n][0] == FWD}}
        bwd_fns = {"as_built": fa._bwd_kernels(), **{n: f for n, f in built.items() if VARIANTS[n][0] == BWD}}
        for shape, b, t, lengths, h in SHAPES:
            q, k, v, lens = chip_smoke.attention_inputs(b, t, lengths, torch.bfloat16, gen, h)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            for rate in chip_smoke.RATES:
                seed = chip_smoke.DROPOUT_SEED if rate else None
                want_o, lse = fa.flash_attention_plain(q, k, v, lens, rate, seed, return_lse=True)
                args = (q, k, v, do, lse, fa.attention_delta(want_o, do), lens, rate, seed)
                want_dq = fa.flash_attention_bwd_plain(*args)[0]

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate)

                with torch.no_grad():
                    sdpa_fwd = chip_smoke.cuda_ms(sdpa, 20)
                sdpa_bwd = chip_smoke.cuda_ms(
                    lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do.transpose(1, 2)), 20) - sdpa_fwd

                def fwd():
                    return fa.flash_attention_fwd(q, k, v, lens, rate, seed, return_lse=bool(rate))[0]

                def share(got, want, backward=False):
                    _, s, zeros = chip_smoke.attention_error(got, want, lens, backward)
                    return s if zeros else float("inf")

                results = {
                    "fwd": (in_turns(fwd_fns, lambda f: setattr(fa, "_fwd_fn", f), fwd,
                                     lambda: share(fwd(), want_o)), sdpa_fwd),
                    "dq": (in_turns(bwd_fns, lambda f: setattr(fa, "_bwd_fns", f),
                                    lambda: fa.flash_attention_bwd_dq(*args),
                                    lambda: share(fa.flash_attention_bwd_dq(*args), want_dq, True)), sdpa_bwd),
                }
                for kernel, ((times, shares), library_ms) in results.items():
                    bound_ms, bound_by = chip_smoke.attention_bound(kernel, lengths, t, torch.bfloat16, h)
                    for name, readings in times.items():
                        print(json.dumps({
                            "kernel": kernel, "shape": shape, "rate": rate, "variant": name, "ms": readings,
                            "limit_share": shares[name], "sdpa_ms": library_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "card": card,
                        }), flush=True)
        fa._fwd_fn, fa._bwd_fns = fwd_fns["as_built"], bwd_fns["as_built"]


if __name__ == "__main__":
    main()
