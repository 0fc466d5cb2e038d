"""ctypes binding to the repository's native JPEG decode + augment library.

The port's own binding to ``native/decode.cpp`` (the same API as
``xmc_gan_tpu/data/native.py``: ``available``, ``decode_train``,
``decode_test``).  Every call releases the GIL, so the DataLoader's worker
threads decode in parallel.  ``available()`` gates its use: where ``g++`` or
libjpeg is missing, ``data/pipeline.py`` takes the PIL route with the same
crop and flip draws.  ``XMC_NATIVE_DECODE=0`` turns it off.

The library is built at first use into ``xmc_gan_tpu_torch/_build/``
(gitignored), named by a hash of the source and flags, as the CUDA kernels
are (``ops/cuda/build.py``): ``g++`` writes a per-process temporary file
that is renamed into place, so processes that build at once never load a
half-written library.  No ``-march=native``: the library carries no
instructions of the machine that built it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "GXX_FLAGS", "build", "available", "decode_train", "decode_test"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "decode.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_lib = None
_tried = False


def build(build_dir: Path | None = None) -> Path | None:
    """Compile ``SOURCE`` into ``build_dir`` (default ``BUILD_DIR``), once per
    source content and flags, and return the library's path; None where the
    source, ``g++`` or libjpeg is missing or the compile fails."""
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    if not SOURCE.is_file():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    lib = build_dir / f"libxmc_decode-{digest}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, prefix=lib.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE), "-ljpeg"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("XMC_NATIVE_DECODE", "1") == "0":
            return None
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.xmc_decode_train.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int, u8p,
        ]
        lib.xmc_decode_train.restype = ctypes.c_int
        lib.xmc_decode_test.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, u8p]
        lib.xmc_decode_test.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_u8p(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


# DCT-scaled decode (libjpeg scale_denom) is on by default: it only engages
# when the source is >= 4x the resize target on the short side (the C side
# keeps >= 2x oversampling for the triangle filter), staying within a few
# uint8 LSBs of the exact path.  XMC_DCT_SCALE=0 forces the exact decode.
_FAST = os.environ.get("XMC_DCT_SCALE", "1") != "0"


def decode_train(
    jpeg_bytes: bytes, out_size: int, short_side: int,
    u_x: float, u_y: float, flip: bool, fast: bool | None = None,
) -> np.ndarray | None:
    """Decode + shorter-side resize + crop(u_x, u_y) + optional flip -> uint8
    HWC.  Returns None on decode failure (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native decoder is not available; check available() first")
    out = np.empty((out_size, out_size, 3), np.uint8)
    rc = lib.xmc_decode_train(
        _as_u8p(jpeg_bytes), len(jpeg_bytes), out_size, short_side,
        float(u_x), float(u_y), int(flip),
        int(_FAST if fast is None else fast),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def decode_test(
    jpeg_bytes: bytes, out_size: int, fast: bool | None = None
) -> np.ndarray | None:
    """Decode + exact resize to ``out_size`` squared -> uint8 HWC, or None."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native decoder is not available; check available() first")
    out = np.empty((out_size, out_size, 3), np.uint8)
    rc = lib.xmc_decode_test(
        _as_u8p(jpeg_bytes), len(jpeg_bytes), out_size,
        int(_FAST if fast is None else fast),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None
