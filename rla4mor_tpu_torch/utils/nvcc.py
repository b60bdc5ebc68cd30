"""Build a CUDA source of the package into a shared library and load it.

The kernels are plain-C-interface ``.cu`` files under ``csrc/``, compiled
with ``nvcc`` for ``sm_90a`` and loaded with :mod:`ctypes`. Nothing here
runs at import time: a library is built the first time a kernel is called
on a CUDA tensor (or when :func:`load` is called), into
``rla4mor_tpu_torch/_build/``, and rebuilt when the source's hash changes.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# loaded libraries by source name
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of rla4mor_tpu_torch are built from source at first use"
    )


def library_path(source: str) -> Path:
    """Build output for ``csrc/<source>``, named by the source's hash."""
    digest = hashlib.sha256(
        (CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> tuple[Path, float]:
    """Compile ``csrc/<source>`` unless its current build exists.

    Returns ``(library path, build seconds)``; 0.0 seconds when the build
    was already there. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside the library as
    ``.log``."""
    out = library_path(source)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building it first if needed."""
    if source not in _LOADED:
        _LOADED[source] = ctypes.CDLL(str(build(source)[0]))
    return _LOADED[source]


def loaded() -> tuple[str, ...]:
    """Sources whose library this process has loaded."""
    return tuple(_LOADED)
