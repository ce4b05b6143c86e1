"""What holds the int8 GEMM and the int8 row quantize (PyTorch port, one
NVIDIA card).

    python3 tools/torch_int8_limits.py [--first DIR]

Times ``csrc/int8_matmul.cu`` as built and variants of it at the dense
sites of wav2vec2-LARGE (M = 4 x 1449, phase 12's longest bucket batch)
and BASE (M = 48 x 149), each variant compiled into a temporary directory
and timed in turns with the build as it is (as built first and last).
``--first DIR`` adds a build of another ``int8_matmul.cu`` (with its
``hopper.cuh``) from ``DIR``: an earlier version of the kernels behind the
same C interface. The tile choices and the earlier
version are held bit-equal to the plain version too; every other variant
computes wrong outputs, and only its times are read:

- ``tile_64`` ... ``tile_256``: the GEMM with its tile width forced
  (the launch rule's choices, each at every site);
- ``no_stores``: the GEMM's epilogue stages its output chunks in shared
  memory but never stores them to the output;
- ``no_products``: no wgmma (the loads, barriers and epilogue);
- ``loads_only``: both of the above;
- ``ring_only``: ``loads_only`` without the epilogue's arithmetic (the
  TMA ring and its barriers alone);
- ``no_fence``, ``no_chunk_wait``, ``no_rescale``: the epilogue without
  its proxy fence before each chunk's store, without the wait for a chunk
  buffer's earlier store, or with the rescale cut to the int-to-float
  conversion;
- ``no_division``: the quantize multiplies by the scale in place of the
  IEEE division.

Before timing, the build as it is is held bit-equal to the plain versions
at every site. Prints the card, the ``-Xptxas -v`` report of the build, and
one JSON line per kernel, variant and site (device ms by CUDA events; the
GEMM's with its bound and TOP/s), the host microseconds a call of
``int8_matmul`` takes at a small shape where the card waits on the host
(each build in turns), then the bf16 ``F.linear`` of each site
(bf16 x, bf16 w, bias) as the yardstick of int8 serving. Needs ``nvcc``
and one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from w2v2_speaker_tpu_torch.ops import _build  # noqa: E402
from w2v2_speaker_tpu_torch.ops import quant  # noqa: E402

M_LARGE, M_BASE = 4 * 1449, 48 * 149
NO_STORES = [("          if (lane == 0) tma_store_2d(&maps.out, chunk, n0 + c * kChunkCols, m0 + 64 * wg + (warp & 3) * 16);\n",
               "")]
NO_MMA = [("        for (int k32 = 0; k32 < kBK / 32; ++k32) wgmma_ss_s8<BN>(acc, da + 2 * k32, db + 2 * k32, s | k32);\n",
           "        if (da == db) wgmma_ss_s8<BN>(acc, da, db, 1);\n")]
VARIANTS = {  # name: [(old, new)], each old text occurring once
    **{f"tile_{bn}": [("  switch (tile_n(p.M, p.N, sms)) {", f"  switch ({bn}) {{")] for bn in (64, 128, 192, 256)},
    "no_stores": NO_STORES,
    "no_products": NO_MMA,
    "loads_only": NO_STORES + NO_MMA,
    "ring_only": NO_STORES + NO_MMA + [("      named_barrier(1 + wg, 128);\n",
                                         "      named_barrier(1 + wg, 128);\n      if (p.K > 0) continue;\n")],
    "no_fence": [("          fence_proxy_async();\n", "")],
    "no_chunk_wait": [("          if (lane == 0) bulk_wait_read<1>();\n", "")],
    "no_rescale": [("  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xm), k);\n  return has_bias ? __fadd_rn(v, b) : v;",
                    "  return __int2float_rn(acc);")],
    "no_division": [("rintf(__fdiv_rn(v[e], scale))", "rintf(v[e] * scale)")],
}
EXACT = ("tile_64", "tile_128", "tile_192", "tile_256", "first_version")  # held bit-equal too
GEMM_VARIANTS = ("tile_64", "tile_128", "tile_192", "tile_256", "no_stores", "no_products", "loads_only",
                 "ring_only", "no_fence", "no_chunk_wait", "no_rescale")


# appended to an earlier version that predates the launch rule's entry point
TILE_STUB = '\nextern "C" int int8_gemm_tile_n(int, int) { return 128; }\n'


def build_variant(name: str, src_dir: pathlib.Path, out_dir: pathlib.Path, edits) -> ctypes.CDLL:
    work = out_dir / name
    work.mkdir()
    src = (src_dir / "int8_matmul.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, f"{name}: {old!r}"
        src = src.replace(old, new)
    if "int8_gemm_tile_n" not in src:
        src += TILE_STUB
    (work / "int8_matmul.cu").write_text(src)
    shutil.copy(src_dir / "hopper.cuh", work / "hopper.cuh")
    lib = work / "libint8.so"
    _build.compile_library(work / "int8_matmul.cu", lib)
    return quant.bind(ctypes.CDLL(str(lib)))


def sites() -> list:
    return ([(f"LARGE {i}", M_LARGE, n, k) for i, (n, k) in enumerate(chip_smoke.INT8_LARGE_SITES)]
            + [(f"BASE {i}", M_BASE, n, k) for i, (n, k) in enumerate(chip_smoke.INT8_BASE_SITES)])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first", type=pathlib.Path, default=None,
                    help="a directory holding an earlier int8_matmul.cu and its hopper.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_limits: needs a CUDA card")
    card = chip_smoke.card_line()
    print(card, flush=True)
    for line in _build.build("int8_matmul").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas", line.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(33)
    inputs = {}
    for label, m, n, k in sites():
        x, w, bias = chip_smoke.int8_inputs(m, n, k, gen)
        xq, xs = quant.quantize_rows(x)
        wq, ks = quant.quantize_rows(w)
        for (q, sc), t in (((xq, xs), x), ((wq, ks), w)):
            pq, ps = quant.quantize_rows_reference(t)
            assert torch.equal(q, pq) and torch.equal(sc, ps), f"{label}: quantize differs from plain"
        out = quant.int8_gemm(xq, wq, xs, ks, bias, torch.bfloat16)
        assert torch.equal(out, quant.int8_gemm_reference(xq, wq, xs, ks, bias, torch.bfloat16)), label
        inputs[label] = (m, n, k, x, w, bias, xq, xs, wq, ks)
        print(f"{label} M={m} N={n} K={k}: bit-equal, tile {quant.gemm_tile(m, n)}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(name, _build.CSRC_DIR, edits) for name, edits in VARIANTS.items()]
        if args.first is not None:
            jobs.append(("first_version", args.first, []))
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:  # one nvcc a variant, all at once
            built = pool.map(lambda job: build_variant(job[0], job[1], pathlib.Path(tmp), job[2]), jobs)
            libs = {"as_built": quant._kernels(), **dict(zip((job[0] for job in jobs), built))}
        real = quant._lib
        for name in EXACT:
            if name not in libs:
                continue
            quant._lib = libs[name]
            for label, (m, n, k, x, w, bias, xq, xs, wq, ks) in inputs.items():
                got = quant.int8_gemm(xq, wq, xs, ks, bias, torch.bfloat16)
                assert torch.equal(got, quant.int8_gemm_reference(xq, wq, xs, ks, bias, torch.bfloat16)), (name, label)
            print(f"{name}: bit-equal at every site", flush=True)
        gemm_order = ["as_built", *GEMM_VARIANTS, *(["first_version"] if args.first else []), "as_built"]
        quant_order = ["as_built", "no_division", *(["first_version"] if args.first else []), "as_built"]
        for label, (m, n, k, x, w, bias, xq, xs, wq, ks) in inputs.items():
            ops_ms = 2e3 * m * n * k / chip_smoke.PEAK_INT8
            bytes_ms = 1e3 * (m * k + n * k + 4 * (m + 2 * n) + 2 * m * n) / chip_smoke.PEAK_BYTES
            times = {}
            for name in gemm_order:
                quant._lib = libs[name]
                times.setdefault(name, []).append(
                    chip_smoke.cuda_ms(lambda: quant.int8_gemm(xq, wq, xs, ks, bias, torch.bfloat16), 20))
            for name, ms in times.items():
                print(json.dumps({"kernel": "int8_gemm", "site": label, "M": m, "N": n, "K": k, "variant": name,
                                  "ms": ms, "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
                                  "bytes_ms": bytes_ms, "top_s": [2 * m * n * k / t / 1e9 for t in ms],
                                  "card": card}), flush=True)
            times = {}
            for name in quant_order:
                quant._lib = libs[name]
                times.setdefault(name, []).append(
                    [chip_smoke.cuda_ms(lambda: quant.quantize_rows(t), 20) for t in (x, w)])
            for name, ms in times.items():
                print(json.dumps({"kernel": "int8_quantize", "site": label, "M": m, "N": n, "K": k,
                                  "variant": name, "x_ms": [t[0] for t in ms], "w_ms": [t[1] for t in ms],
                                  "x_bound_ms": 1e3 * (3 * m * k + 4 * m) / chip_smoke.PEAK_BYTES,
                                  "w_bound_ms": 1e3 * (5 * n * k + 4 * n) / chip_smoke.PEAK_BYTES,
                                  "card": card}), flush=True)
        # host time a call of int8_matmul (two quantizes and the GEMM) where the
        # card waits on the host: BASE's B=8 x 3 s feature projection
        x, w = torch.randn(8 * 149, 512, device="cuda").to(torch.bfloat16), torch.randn(768, 512, device="cuda")
        bias = torch.randn(768, device="cuda")
        for name in ["as_built", *(["first_version"] if args.first else []), "as_built"]:
            quant._lib = libs[name]
            for _ in range(20):
                quant.int8_matmul(x, w, bias, torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                quant.int8_matmul(x, w, bias, torch.bfloat16)
            torch.cuda.synchronize()
            print(json.dumps({"kernel": "int8_matmul host", "variant": name, "M": x.shape[0], "N": 768, "K": 512,
                              "us_per_call": (time.perf_counter() - t0) / 500 * 1e6, "card": card}), flush=True)
        quant._lib = real
    for label, (m, n, k, x, w, bias, *_) in inputs.items():
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        print(json.dumps({"kernel": "bf16 F.linear", "site": label, "M": m, "N": n, "K": k,
                          "ms": chip_smoke.cuda_ms(lambda: F.linear(x, wb, bb), 20), "card": card}), flush=True)


if __name__ == "__main__":
    main()
