"""Where the planted faults of ``tools/torch_fault_probe.py`` land in the
kernel sources: every edit's text occurs in its source, and each mutant
changes the bf16 path (the main path's kernel, its launch code or a helper
it calls) as well as the f32 kernel; the mutants planted in the f32
backward kernels alone (``f32_*``) change both of them. The probe itself
needs the card; this reads the sources only, and runs the dv bisection's
one-flip analysis on the plain version."""

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "w2v2_speaker_tpu_torch" / "csrc"
# (bf16 kernel and its launch code, f32 kernel) per mutant family
PATHS = {
    "conv": (("conv_encoder_bf16_kernel", "launch_bf16"), ("conv_encoder_f32_kernel",)),
    "dkv": (("dkv_bf16_kernel",), ("dkv_f32_kernel",)),
    "fwd": (("fwd_bf16_kernel",), ("fwd_f32_kernel",)),
    "dq": (("dq_bf16_kernel",), ("dq_f32_kernel",)),
}


def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_fault_probe", ROOT / "tools" / "torch_fault_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PROBE = _probe()
MUTANTS = PROBE.MUTANTS


def _definition(src: str, name: str) -> str:
    """The text of function ``name``'s definition, brace-matched."""
    match = re.search(rf"\b{name}\s*\([^;{{}}]*\)\s*\{{", src)
    assert match, f"{name} is not defined"
    depth = 0
    for end in range(match.end() - 1, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            return src[match.start():end + 1]
    raise AssertionError(f"{name}: unbalanced braces")


def _path(src: str, roots) -> list:
    """The definitions of ``roots`` and of every device helper they call."""
    bodies = [_definition(src, name) for name in roots]
    helpers = re.findall(r"__device__ __forceinline__ (?:[\w:<>]+\s+)+(\w+)\s*\(", src)
    called = {h for h in helpers if any(re.search(rf"\b{h}\s*\(", b) for b in bodies)}
    return bodies + [_definition(src, h) for h in sorted(called)]


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_every_edit_occurs_in_its_source(name):
    source, edits = MUTANTS[name]
    src = (CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        assert old != new and src.count(old) >= 1, f"{name}: {old!r}"


@pytest.mark.parametrize("name", sorted(n for n in MUTANTS if n.split("_")[0] in PATHS))
def test_mutant_reaches_the_bf16_and_f32_kernels(name):
    source, edits = MUTANTS[name]
    src = (CSRC / f"{source}.cu").read_text()
    bf16, f32 = PATHS[name.split("_")[0]]
    for roots in (bf16, f32):
        bodies = _path(src, roots)
        assert any(old in body for old, _ in edits for body in bodies), (
            f"{name} leaves {'/'.join(roots)} unchanged")


@pytest.mark.parametrize("name", sorted(n for n in MUTANTS if n.startswith("f32_")))
def test_f32_mutant_reaches_both_f32_backward_kernels(name):
    source, edits = MUTANTS[name]
    assert source == "flash_attention_bwd" and name in PROBE.F32_MUTANTS
    src = (CSRC / f"{source}.cu").read_text()
    for kernel in ("dq_f32_kernel", "dkv_f32_kernel"):
        bodies = _path(src, (kernel,))
        assert any(old in body for old, _ in edits for body in bodies), f"{name} leaves {kernel} unchanged"
    for kernel in ("dq_bf16_kernel", "dkv_bf16_kernel"):
        bodies = _path(src, (kernel,))
        assert not any(old in body for old, _ in edits for body in bodies), f"{name} changes {kernel}"


def test_one_flip_finds_the_p_whose_rounding_moved_dv():
    """``one_flip`` on CPU tensors: a dv computed with one P of a key's
    column rounded to its other bf16 neighbour is explained by that query,
    and the unflipped dv by a flip that changes nothing much."""
    import torch

    from w2v2_speaker_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)
    b, t, h, d, n = 1, 64, 2, 64, 40
    q, k, do = (torch.randn(b, t, h, d, generator=gen).to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor([n])
    _, lse = fa.flash_attention_plain(q, k, k, lens, return_lse=True)
    key, head, ch, query = 7, 1, 5, 23
    qs = q[0, :n, head] * fa._scale(d, q.dtype)
    p = torch.exp2(qs.float() @ k[0, key, head].float() - lse[0, head, :n])
    pb = p.to(torch.bfloat16)
    bits = pb.view(torch.int16)
    other = torch.where(pb.float() < p, bits + 1, bits - 1).to(torch.int16).view(torch.bfloat16)
    flipped = pb.float().clone()
    flipped[query] = other[query].float()
    dov = do[0, :n, head, ch].float()
    kernel_value = float((flipped * dov).sum())
    got = PROBE.one_flip(q, k, do, lse, (0, key, head, ch), n, kernel_value)
    assert got["query"] == query
    assert got["dv_one_flip"] == pytest.approx(kernel_value, abs=1e-6)
    assert got["dv_f32"] == pytest.approx(float((pb.float() * dov).sum()), abs=1e-6)
    assert 0 <= got["ulps_from_midpoint"] <= 0.5
