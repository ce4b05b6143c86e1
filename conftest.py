"""Build the native libraries once, before any test process starts.

``native/*.so`` are not committed, so a fresh checkout has none, and the
loaders of ``w2v2_speaker_tpu/utils/{flac,native}.py`` run ``make`` at
first use. Under ``pytest -n N`` every xdist worker imports
``tests/test_flac.py``, whose module-level ``skipif`` calls the FLAC
loader: N processes then run ``make`` on the same target at once, the
Makefile writes each library in place, and a worker that ``dlopen``s a
half-written file caches "unavailable" for its whole life. Building here,
in the one controlling process and before the workers exist, leaves them
a finished library to load.

A failed build is printed, not raised: the loaders' own ``available()``
then decides as they would without this file.
"""

from __future__ import annotations

import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parent / "native"
BUILD_TIMEOUT_S = 300


def pytest_configure(config) -> None:
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built
        return
    try:
        proc = subprocess.run(
            ["make", "-C", str(NATIVE_DIR)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=BUILD_TIMEOUT_S,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"conftest: make -C {NATIVE_DIR} did not run: {e!r}")
        return
    if proc.returncode != 0:
        print(f"conftest: make -C {NATIVE_DIR} failed ({proc.returncode}):\n{proc.stdout}")
