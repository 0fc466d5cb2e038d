"""Build the port's CUDA sources at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` exposes plain C functions.  ``nvcc`` compiles one source
into a shared library for ``sm_90a`` (Hopper) inside ``_build/`` next to the
package sources (listed in ``.gitignore``; nothing is prebuilt).  The library
name carries a hash of the source and flags, so an edited source is rebuilt
rather than loaded stale.  Pointers and the stream cross as
``ctypes.c_void_p``.

A missing ``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "CudaLibrary",
           "LaunchCount"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        f"nvcc not found on PATH or at {candidate}; the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit (set CUDA_HOME)"
    )


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into ``_build/`` (once per source content) and
    return the library's path.  Safe to run from several processes at once:
    each compiles into a temporary file and renames it into place."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=lib.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


class LaunchCount:
    """The launch count of one kernel: a plain integer that the kernel's
    wrapper raises by one at each launch and nowhere else, so a run can show
    which kernels it went through (``chip_smoke.py`` zeroes every count
    before a main path and reads them after)."""

    def __init__(self):
        self.launches = 0


class CudaLibrary:
    """A ``csrc`` source, compiled and loaded on first use.

    ``signatures`` maps each exported C function to ``(restype, argtypes)``;
    they are declared once, when the library is loaded.  Each kernel's launch
    count is a ``LaunchCount`` beside its wrapper.
    """

    def __init__(self, source: str, signatures: dict[str, tuple[Any, list[Any]]]):
        self.source = source
        self.signatures = signatures
        self._lib: ctypes.CDLL | None = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build(self.source)))
            for name, (restype, argtypes) in self.signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            self._lib = lib
        return self._lib
