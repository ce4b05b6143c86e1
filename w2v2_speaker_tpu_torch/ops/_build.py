"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, from the sources in the checkout only, into
``build/torch_kernels/`` beside the package (listed in ``.gitignore``). The
library's file name carries a hash of its source, so an edited kernel is
never served from a stale build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "CSRC_DIR", "build", "compile_library", "load"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    # PyTorch's own lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, then the
    # toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME and nvcc.is_file():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from csrc/ at first use"
    )


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_library(src: Path, out: Path) -> str:
    """``nvcc`` ``src`` into the shared library ``out``; returns the
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return proc.stdout


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current library exists; returns
    the ``nvcc`` report of a new build ("" when none was needed)."""
    out = _library_path(name)
    if out.exists():
        return ""
    return compile_library(CSRC_DIR / f"{name}.cu", out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
