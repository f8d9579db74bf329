"""The uint8 factor codec of the image app (``codec.cpp``, the JAX
package's ``native/codec.cpp`` copied), built with the host C++ compiler
and loaded with ``ctypes``.

``codec.cpp`` compiles at first use with ``c++ -O3 -fPIC -Wall -Wextra
-std=c++17 -shared`` (the JAX package's Makefile flags; no fast math)
into the package's ``build/libcodec-<hash>.so``, ``<hash>`` covering the
source and the flags.  A failed build raises: unlike the JAX package,
which falls back to numpy when its library is missing, nothing here runs
another codec in its place.  The MatrixMarket reader (``mmio.cpp``)
waits for the port of ``core/io.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")

_lock = threading.Lock()
_codec = None

_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcodec-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``codec.cpp`` unless its library exists; return its path.
    Raises ``RuntimeError`` when no compiler is found or the build
    fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                           "image codec builds from native/codec.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)     # atomic: each concurrent build has its own tmp
    return out


class Codec:
    """numpy-typed wrappers of the four C functions of ``codec.cpp``."""

    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        cdll.codec_quantize_affine.restype = None
        cdll.codec_quantize_affine.argtypes = [_F64P, ctypes.c_int64, _U8P,
                                               _F64P, _F64P]
        cdll.codec_dequantize_affine.restype = None
        cdll.codec_dequantize_affine.argtypes = [_U8P, ctypes.c_int64,
                                                 ctypes.c_double,
                                                 ctypes.c_double, _F64P]
        cdll.codec_quantize_truncate.restype = None
        cdll.codec_quantize_truncate.argtypes = [_F64P, ctypes.c_int64, _U8P]
        cdll.codec_dequantize_truncate.restype = None
        cdll.codec_dequantize_truncate.argtypes = [_U8P, ctypes.c_int64,
                                                   _F64P]

    def quantize_affine(self, x: np.ndarray):
        """(q uint8, scale, offset): q = rint((x - lo) * (1 / scale)),
        scale = (max - min) / 255 (1 for a constant x), offset = min, in
        f64."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.size == 0:
            raise ValueError("quantize_affine of an empty array has no range")
        out = np.empty(x.size, dtype=np.uint8)
        scale, offset = ctypes.c_double(), ctypes.c_double()
        self._lib.codec_quantize_affine(
            x.ctypes.data_as(_F64P), x.size, out.ctypes.data_as(_U8P),
            ctypes.byref(scale), ctypes.byref(offset))
        return out.reshape(x.shape), scale.value, offset.value

    def dequantize_affine(self, q: np.ndarray, scale: float, offset: float):
        q = np.ascontiguousarray(q, dtype=np.uint8)
        out = np.empty(q.size, dtype=np.float64)
        self._lib.codec_dequantize_affine(
            q.ctypes.data_as(_U8P), q.size, scale, offset,
            out.ctypes.data_as(_F64P))
        return out.reshape(q.shape)

    def quantize_truncate(self, x: np.ndarray):
        """The reference's bytes: ``(uint8)((int)x & 0xFF)``."""
        x = np.ascontiguousarray(x, dtype=np.float64)
        out = np.empty(x.size, dtype=np.uint8)
        self._lib.codec_quantize_truncate(
            x.ctypes.data_as(_F64P), x.size, out.ctypes.data_as(_U8P))
        return out.reshape(x.shape)

    def dequantize_truncate(self, q: np.ndarray):
        q = np.ascontiguousarray(q, dtype=np.uint8)
        out = np.empty(q.size, dtype=np.float64)
        self._lib.codec_dequantize_truncate(
            q.ctypes.data_as(_U8P), q.size, out.ctypes.data_as(_F64P))
        return out.reshape(q.shape)


def get_codec() -> Codec:
    """The loaded codec, built at first use; raises when it cannot be
    built or loaded."""
    global _codec
    with _lock:
        if _codec is None:
            _codec = Codec(ctypes.CDLL(str(build())))
    return _codec
