"""Planted faults against the limits of ``chip_smoke.py`` (PyTorch port, one
NVIDIA card).

    python3 tools/torch_fault_probe.py

Reads each limit twice: on the correct code (over several seeds), and on a
deliberately wrong copy of it. A limit is worth keeping only where the
first reading sits well under it and the second well over it.

- Kernels vs plain versions (``chip_smoke.kernel_errors``: the share of
  ``fa.kernel_tolerance`` used by the worst element of o, lse, dq, dk and
  dv, with dk and dv also read without the per-element rounding slack of
  ``fa.backward_rounding_slack``), at the shapes of
  ``chip_smoke.ATTN_SHAPES``, in float32 and bfloat16, at dropout rates 0
  and 0.1, at seeds 0-7, for the kernels as built and for mutants
  compiled into a temporary directory, each planted in the bf16
  (wgmma) and the f32 kernel: the forward without the boundary K/V tile
  mask, without the accumulator rescale, or with the normalizer summing
  the dropped P; the dk/dv kernels without the keep mask on dP, or
  without the division of dk by log2 e; the dq kernel without its
  boundary handling (no key mask, and the boundary tile loaded up to T
  instead of the length: with the tile's keys past the length
  zero-filled, as the built kernel loads them, a missing mask alone
  changes no dq, since those keys' rows of K are 0). Planted in the f32
  kernels alone: the 3xTF32 products without their lo terms, and the
  transposed staging tiles misindexed. In float32 each reading also holds
  dq, dk and dv to the float64 rule and two launches to the same bits
  (``chip_smoke.attention_pair_errors``).
- The fused conv vs its plain version (``chip_smoke.conv_errors``: the
  share of ``ce.kernel_tolerance`` used by the worst element over the
  layers), at ``chip_smoke``'s ragged short inputs and the BASE (B=66) and
  LARGE (B=48) conv layers 1-6, in float32 and bfloat16, as built and for
  mutants: the LayerNorm without its mean subtraction; tap 2 read from
  x[2t+1] instead of x[2t+2] (the f32 kernel's A offset, the bf16 kernel's
  tap-2 tensor map); the ragged last frame tile's store unmasked (in every
  batch row but the last, whose spill would leave the output buffer: the
  spilled frames land on the next row's first frames; the bf16 kernel's
  rows past T_out hold the zero-filled A rows' outputs).
- Padding invariance of bucketed serving (``chip_smoke.padding_ratio``), for
  the port as it is, with two embeddings handed back swapped (the closest
  pair), and with attention that ignores the key lengths.
- The overfit check (``chip_smoke.overfit_fall``) on the training step as
  built (two seeds) and with updates of size 0 (learning rate 0), where the
  loss moves only with the dropout draws.
- The float32 steps of the x-vector, ECAPA-TDNN and wav2spk recipes
  (``chip_smoke.family_f32_readings``: the card's and the CPU's gradients
  against a float64 step's) as built and with TF32 allowed in cuDNN and
  cuBLAS, which ``device.set_float32_precision`` turns off.

Prints one JSON line per reading. Needs ``nvcc`` and one card.

    python3 tools/torch_fault_probe.py --attention

reads only the attention kernels, as built and for their mutants.

    python3 tools/torch_fault_probe.py --f32

reads only the float32 backward kernels (dq, dk/dv), as built (seeds 0-3)
and for ``F32_MUTANTS``: the kernel limits, the float64 rule
(``chip_smoke.ATTN_F64_FACTOR``) and the repeat check (~5 min).

    python3 tools/torch_fault_probe.py --families

reads only the float32 family steps (no kernel is built; ~1 min).

    python3 tools/torch_fault_probe.py --dv-bisect DIR

reads only the dk/dv kernel's dv at ``DIR_SHAPE`` (bf16, rate 0, seeds
0-7), fed the lse and D of three forwards on the same q, k, v and dO: the
plain version, the forward kernel as built, and the forward kernel built
from ``DIR`` (an older ``flash_attention_fwd.cu`` with the headers it
includes, e.g. ``git archive <commit> w2v2_speaker_tpu_torch/csrc``
unpacked there). For each it prints dv's share of its limit, the element
that reads it (batch row, key, head, channel, the row's length, kernel and
plain values, the limit there), and how far that forward's lse lies from
the plain version's on the row.
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
from w2v2_speaker_tpu_torch.models.wav2vec2 import BASE_CONFIG, LARGE_CONFIG  # noqa: E402
from w2v2_speaker_tpu_torch.ops import _build  # noqa: E402
from w2v2_speaker_tpu_torch.ops import conv_encoder as ce  # noqa: E402
from w2v2_speaker_tpu_torch.ops import flash_attention as fa  # noqa: E402
from w2v2_speaker_tpu_torch.runtime.predict import extract_embeddings  # noqa: E402

SEEDS = tuple(range(8))
# the mutants that ``--f32`` reads: those planted in the float32 backward
# kernels
F32_MUTANTS = ("dkv_no_keep_mask_on_dp", "dkv_dk_not_divided_by_log2e", "dq_no_boundary_mask",
               "f32_products_without_lo_terms", "f32_transposed_tile_misindexed")
DIR_SHAPE = "ragged_30s"
# (source, [(old, new)]): each old text must occur in the source; every
# occurrence is replaced. Every mutant plants its fault in both the bf16
# kernel (the main path's) and the f32 one (tests/test_torch_fault_probe.py
# checks where each edit lands).
MUTANTS = {
    "fwd_no_boundary_mask": ("flash_attention_fwd", [
        ("if (k0 + kFwdBlockN > len) {  // boundary tile: mask keys >= len", "if (false) {"),
        ("s[jj] = j0 + jj < n_valid ? dot : -INFINITY;", "s[jj] = dot;"),
    ]),
    "fwd_no_acc_rescale": ("flash_attention_fwd", [
        ("#pragma unroll\n        for (int i = 0; i < 32; ++i) acc[i] *= alpha[acc_half(i)];\n", ""),
        ("for (int d = 0; d < kD; ++d) acc[d] *= alpha;", ""),
    ]),
    "fwd_row_sum_after_dropout": ("flash_attention_fwd", [
        ("#pragma unroll\n      for (int i = 0; i < kFwdBlockN / 2; ++i) rs[acc_half(i)] += s[i];"
         "  // l sums the undropped P\n", ""),
        ("      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];\n",
         "      for (int i = 0; i < kFwdBlockN / 2; ++i) rs[acc_half(i)] += s[i];\n#pragma unroll\n"
         "      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];\n"),
        ("        rs += s[jj];\n", "        rs += kDrop ? p.drop.apply(s[jj], dbh, row, k0 + j0 + jj) : s[jj];\n"),
    ]),
    "dkv_no_keep_mask_on_dp": ("flash_attention_bwd", [
        ("          dpv = kp ? dpv * p.drop.inv_keep : 0.f;\n", ""),  # the bf16 and the f32 kernel
    ]),
    "dkv_dk_not_divided_by_log2e": ("flash_attention_bwd", [
        (" / kLog2e : 0.f", " : 0.f"),  # the bf16 and the f32 kernel
    ]),
    "dq_no_boundary_mask": ("flash_attention_bwd", [
        ("const bool valid = live && rv[r] && (!boundary || key < len);", "const bool valid = live && rv[r];"),
        ("cp_async_tile(dst, kg + k0 * p.k_st, p.k_st, len - k0, tid);",
         "cp_async_tile(dst, kg + k0 * p.k_st, p.k_st, p.T - k0, tid);"),
        ("cp_async_tile(dst + kTileBytes, vg + k0 * p.v_st, p.v_st, len - k0, tid);",
         "cp_async_tile(dst + kTileBytes, vg + k0 * p.v_st, p.v_st, p.T - k0, tid);"),
        ("const bool valid = rv[r] && (!boundary || key < len);", "const bool valid = rv[r];"),
        ("cp_async_tile_f32(land, kg + k0 * p.k_st, p.k_st, len - k0, tid);",
         "cp_async_tile_f32(land, kg + k0 * p.k_st, p.k_st, p.T - k0, tid);"),
        ("cp_async_tile_f32(land + kF32Tile, vg + k0 * p.v_st, p.v_st, len - k0, tid);",
         "cp_async_tile_f32(land + kF32Tile, vg + k0 * p.v_st, p.v_st, p.T - k0, tid);"),
    ]),
    # f32 only: the products in 1xTF32 (every lo part 0: ~3 decimal
    # digits, which kernel_tolerance can pass on short rows and the float64
    # rule should not), and the transposed staging tiles (K^T, qs^T, dO^T)
    # filled from the even rows alone (every odd position reads the row
    # before it)
    "f32_products_without_lo_terms": ("flash_attention_bwd", [
        ("    *reinterpret_cast<float4*>(lo + at) = l;",
         "    *reinterpret_cast<float4*>(lo + at) = make_float4(0.f, 0.f, 0.f, 0.f);"),
        ("    *reinterpret_cast<float4*>(lo_t + at) = make_float4(l[0], l[1], l[2], l[3]);",
         "    *reinterpret_cast<float4*>(lo_t + at) = make_float4(0.f, 0.f, 0.f, 0.f);"),
        ("      a_lo[s][j] = __float_as_uint(tf32_round(v - h));", "      a_lo[s][j] = 0u;"),
    ]),
    "f32_transposed_tile_misindexed": ("flash_attention_bwd", [
        ("const int r0 = 8 * (q >> 1) + (q & 1);", "const int r0 = 8 * (q >> 1);"),
    ]),
    "conv_ln_no_mean_subtraction": ("conv_encoder", [
        ("  return (v - mean) * rstd * s + lb;", "  return v * rstd * s + lb;"),
    ]),
    "conv_tap2_reads_x_2t_plus_1": ("conv_encoder", [
        ("  return (static_cast<long long>(b) * p.T_in + 2LL * t) * p.C + kk;",
         "  return (static_cast<long long>(b) * p.T_in + 2LL * t) * p.C"
         " + (kk >= 2 * p.C ? kk - p.C : kk);"),
        ("    const int first = j;  // tap j starts at input frame j",
         "    const int first = j == 2 ? 1 : j;"),
    ]),
    "conv_ragged_tile_store_unmasked": ("conv_encoder", [
        ("if (t0 + row < p.T_out) {", "if (t0 + row < p.T_out || b + 1 < p.B) {"),
    ]),
}


def build_mutant(name: str, out_dir: pathlib.Path) -> None:
    """Compile the mutant and put its entry points in place of the built
    kernels' in ``fa``."""
    source, edits = MUTANTS[name]
    src = (_build.CSRC_DIR / f"{source}.cu").read_text()
    for old, new in edits:
        assert src.count(old) >= 1, f"{name}: {old!r} does not occur"
        src = src.replace(old, new)
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    lib = out_dir / f"lib{name}.so"
    _build.compile_library(path, lib)
    if source == "flash_attention_fwd":
        fa._fwd_fn = fa.bind(ctypes.CDLL(str(lib)))
    elif source == "conv_encoder":
        ce._fn = ce.bind(ctypes.CDLL(str(lib)))
    else:
        fa._bwd_fns = fa.bind_bwd(ctypes.CDLL(str(lib)))


def conv_readings(variant: str, seeds) -> None:
    sets = {
        "ragged_short": lambda dtype, gen: [chip_smoke.conv_inputs(2, t_in, 512, k, True, dtype, gen)
                                            for t_in, k in chip_smoke.CONV_RAGGED],
        "base_train_3s": lambda dtype, gen: chip_smoke.conv_stack_inputs(BASE_CONFIG, 66, dtype, gen),
        "large_train_3s": lambda dtype, gen: chip_smoke.conv_stack_inputs(
            LARGE_CONFIG, chip_smoke.LARGE_BATCH, dtype, gen),
    }
    for name, make in sets.items():
        for dtype in (torch.float32, torch.bfloat16):
            err, share = 0.0, 0.0
            for seed in seeds:
                gen = torch.Generator(device="cuda").manual_seed(seed)
                e, s = chip_smoke.conv_errors(make(dtype, gen))
                err, share = max(err, e), max(share, s)
            print(json.dumps({
                "limit": "conv", "variant": variant, "shape": name,
                "dtype": str(dtype).removeprefix("torch."), "seeds": len(seeds),
                "max_abs_err": err, "limit_share": share,
            }), flush=True)


def kernel_readings(variant: str, seeds, dtypes=(torch.float32, torch.bfloat16)) -> None:
    """One line per shape, type and rate: each output's worst reading over
    ``seeds``, the reading of the variant (the largest share of any
    output), and the dk and dv shares of each seed."""
    for name, b, t, lengths in chip_smoke.ATTN_SHAPES:
        for dtype in dtypes:
            for rate in chip_smoke.RATES:
                worst, by_seed = {}, {}
                for seed in seeds:
                    gen = torch.Generator(device="cuda").manual_seed(seed)
                    errors, _, _ = chip_smoke.kernel_errors(b, t, lengths, dtype, rate, gen, without_slack=True)
                    for out, (err, share, zeros) in errors.items():
                        e, s, z = worst.get(out, (0.0, 0.0, True))
                        worst[out] = (max(e, err), max(s, share), z and zeros)
                        if out.startswith(("dk", "dv")):
                            by_seed.setdefault(out, []).append(share)
                print(json.dumps({
                    "limit": "kernel", "variant": variant, "shape": name,
                    "dtype": str(dtype).removeprefix("torch."), "rate": rate, "seeds": len(seeds),
                    "reading": max(s for out, (_, s, _) in worst.items() if not out.endswith("without_slack")),
                    **{out: {"max_abs_err": e, "limit_share": s, "zeros_past_length": z}
                       for out, (e, s, z) in worst.items()},
                    "by_seed": by_seed,
                }), flush=True)


def padding_readings() -> None:
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

    def keys_unmasked(q, k, v, lengths, dropout_rate=0.0, seed=None):
        return fa.flash_attention(q, k, v, None, dropout_rate, seed)

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


def overfit_readings() -> None:
    for variant, lr, seeds in (("as_built", chip_smoke.OVERFIT_LR, (2, 4)), ("no_update", 0.0, (2, 4))):
        for seed in seeds:
            losses = chip_smoke.overfit_losses(lr, seed=seed)
            print(json.dumps({
                "limit": "overfit", "variant": variant, "seed": seed, "lr": lr,
                "fall": chip_smoke.overfit_fall(losses), "first": losses[0], "last": losses[-1],
            }), flush=True)


def family_readings() -> None:
    for variant in ("as_built", "tf32"):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = variant == "tf32"
        for recipe in chip_smoke.FAMILY_F32_SEEDS:
            r = chip_smoke.family_f32_readings(recipe)
            print(json.dumps({
                "limit": "family_f32_step", "variant": variant, "recipe": recipe,
                "norm_card": r["norm_card"], "norm_cpu": r["norm_cpu"], "multiple": r["norm_card"] / r["norm_cpu"],
                "norm_limit": r["limit"], "loss": r["loss"], "stats": r["stats"],
                "worst_card": r["worst_card"], "worst_cpu": r["worst_cpu"],
            }), flush=True)
    chip_smoke.set_float32_precision()


def one_flip(q, k, do, lse, at, n, kernel_value) -> dict:
    """Whether one P rounded to the other side explains dv's error at
    ``at`` = (b, key, head, d): the plain version's P column of that key
    (queries < n), rounded to bf16 as it rounds it, and for each query the
    dv that the same sum gives with that one P on its other bf16
    neighbour. Returns the query whose flip lands nearest the kernel's
    value, that P, its distance from the rounding midpoint in units of its
    ulp, and the dv with and without the flip."""
    b, j, h, d = at
    qs = q[b, :n, h] * fa._scale(q.shape[-1], q.dtype).to(q.device)
    p = torch.exp2(qs.float() @ k[b, j, h].float() - lse[b, h, :n])
    pb = p.to(torch.bfloat16)
    bits = pb.view(torch.int16)
    other = torch.where(pb.float() < p, bits + 1, bits - 1).to(torch.int16).view(torch.bfloat16)
    dov = do[b, :n, h, d].float()
    dv32 = float((pb.float() * dov).sum())
    flipped = dv32 + (other.float() - pb.float()) * dov
    i = int((flipped - kernel_value).abs().argmin())
    ulp = (other.float() - pb.float()).abs()
    mid = (other.float() + pb.float()) / 2
    return {"query": i, "p": float(p[i]), "p_bf16": float(pb[i]), "do": float(dov[i]),
            "ulps_from_midpoint": float((p[i] - mid[i]).abs() / ulp[i]),
            "dv_f32": dv32, "dv_one_flip": float(flipped[i]), "kernel": kernel_value}


def dv_bisect(old_csrc: pathlib.Path) -> None:
    """The dv reading at ``DIR_SHAPE`` with the lse and D of each forward."""
    _, b, t, lengths = next(s for s in chip_smoke.ATTN_SHAPES if s[0] == DIR_SHAPE)
    with tempfile.TemporaryDirectory() as tmp:
        lib = pathlib.Path(tmp) / "libold_fwd.so"
        _build.compile_library(old_csrc / "flash_attention_fwd.cu", lib)
        old_fwd = fa.bind(ctypes.CDLL(str(lib)))
        built_fwd = fa._kernel()

        def kernel_fwd(fn):
            def run(q, k, v, lens):
                fa._fwd_fn = fn
                try:
                    return fa.flash_attention_fwd(q, k, v, lens, return_lse=True)
                finally:
                    fa._fwd_fn = built_fwd
            return run

        forwards = {
            "plain": lambda q, k, v, lens: fa.flash_attention_plain(q, k, v, lens, return_lse=True),
            "built": kernel_fwd(built_fwd),
            "old": kernel_fwd(old_fwd),
        }
        for seed in SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            # the draws of chip_smoke.kernel_errors: q, k, v, then dO
            q, k, v, lens = chip_smoke.attention_inputs(b, t, lengths, torch.bfloat16, gen)
            do = torch.randn((b, t, chip_smoke.H, chip_smoke.D), generator=gen,
                             device="cuda").to(torch.bfloat16)
            _, plain_lse = forwards["plain"](q, k, v, lens)
            for name, fwd in forwards.items():
                o, lse = fwd(q, k, v, lens)
                args = (q, k, v, do, lse, fa.attention_delta(o, do), lens)
                _, dv = fa.flash_attention_bwd_dkv(*args)
                _, _, want = fa.flash_attention_bwd_plain(*args)
                valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
                rtol, atol = fa.kernel_tolerance(want[valid], backward=True)
                slack = fa.backward_rounding_slack(*args)[1]
                share = (dv.float() - want.float()).abs() / (atol + rtol * want.float().abs() + slack)
                share = torch.where(valid[:, :, None, None], share, 0.0)
                at = np.unravel_index(int(share.argmax()), share.shape)
                row = at[0]
                print(json.dumps({
                    "limit": "dv_bisect", "forward": name, "shape": DIR_SHAPE, "seed": seed,
                    "limit_share": float(share.max()),
                    "at": {"b": int(row), "key": int(at[1]), "head": int(at[2]), "d": int(at[3]),
                           "length": int(lens[row])},
                    "kernel": float(dv[at]), "plain": float(want[at]),
                    "limit_there": atol + rtol * abs(float(want[at])) + float(slack[at]), "atol": atol,
                    "slack_there": float(slack[at]),
                    "lse_vs_plain_max_abs_row": float(
                        (lse[row][:, : int(lens[row])] - plain_lse[row][:, : int(lens[row])])
                        .abs().max()) if int(lens[row]) else 0.0,
                    "share_by_row": [float(share[i].max()) for i in range(b)],
                    "one_flip": one_flip(q, k, do, lse, at, int(lens[row]), float(dv[at])),
                }), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_fault_probe: needs a CUDA card")
    print(chip_smoke.card_line(), flush=True)
    if sys.argv[1:2] == ["--dv-bisect"]:
        dv_bisect(pathlib.Path(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--families"]:
        family_readings()
        return
    f32_only = sys.argv[1:2] == ["--f32"]
    attention_only = f32_only or sys.argv[1:2] == ["--attention"]
    _build.build_all(chip_smoke.KERNEL_SOURCES)
    kernel_readings("as_built", SEEDS[:4] if f32_only else SEEDS, (torch.float32,) if f32_only else
                    (torch.float32, torch.bfloat16))
    if not attention_only:
        conv_readings("as_built", SEEDS[:4])
    with tempfile.TemporaryDirectory() as tmp:
        for name in MUTANTS:
            if MUTANTS[name][0] == "conv_encoder":
                if attention_only:
                    continue
                build_mutant(name, pathlib.Path(tmp))
                conv_readings(name, SEEDS[:1])
            elif not f32_only or name in F32_MUTANTS:
                build_mutant(name, pathlib.Path(tmp))
                kernel_readings(name, SEEDS[:1], (torch.float32,))
                if not name.startswith("f32_"):
                    kernel_readings(name, SEEDS, (torch.bfloat16,))
            fa._fwd_fn = fa._bwd_fns = ce._fn = None  # the kernels as built again
    if not attention_only:
        padding_readings()
        overfit_readings()
        family_readings()


if __name__ == "__main__":
    main()
