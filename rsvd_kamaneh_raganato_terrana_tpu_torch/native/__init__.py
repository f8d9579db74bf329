"""The host libraries of the JAX package's ``native/``, copied: the uint8
factor codec of the image app (``codec.cpp``) and the MatrixMarket
reader and writer (``mmio.cpp``), each built with the host C++ compiler
and loaded with ``ctypes``.

Each source compiles at first use with ``c++ -O3 -fPIC -Wall -Wextra
-std=c++17 -shared`` (the JAX package's Makefile flags; no fast math)
into the package's ``build/lib<name>-<hash>.so``, ``<hash>`` covering
the source and the flags.  A failed build raises: unlike the JAX
package, which falls back to numpy when its library is missing, nothing
here runs another codec or reader in its place.
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

_HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared")

_lock = threading.Lock()
_loaded = {}

_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path(name: str = "codec") -> Path:
    """The library that ``<name>.cpp`` builds into."""
    digest = hashlib.sha256((_HERE / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str = "codec") -> Path:
    """Compile ``<name>.cpp`` unless its library exists; return its path.
    Raises ``RuntimeError`` when no compiler is found or the build
    fails."""
    out = library_path(name)
    if out.exists():
        return out
    src = _HERE / f"{name}.cpp"
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: "
                           f"native/{src.name} needs one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src.name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)     # atomic: each concurrent build has its own tmp
    return out


def _load(name: str, wrapper):
    """``wrapper`` around the library of ``<name>.cpp``, built and loaded
    once per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = wrapper(ctypes.CDLL(str(build(name))))
    return _loaded[name]


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
    return _load("codec", Codec)


# mmio_read's return codes (mmio.cpp)
_MMIO_ERRORS = {1: "cannot open the file", 2: "short read",
                3: "not a MatrixMarket file", 4: "bad dimensions",
                5: "out of memory", 6: "bad or out-of-range entry",
                7: "unsupported field or symmetry"}


class Mmio:
    """numpy-typed wrappers of ``mmio_read``, ``mmio_free`` and
    ``mmio_write``."""

    def __init__(self, cdll: ctypes.CDLL):
        self._lib = cdll
        cdll.mmio_read.restype = ctypes.c_int
        cdll.mmio_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_F64P),
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64)]
        cdll.mmio_free.restype = None
        cdll.mmio_free.argtypes = [_F64P]
        cdll.mmio_write.restype = ctypes.c_int
        cdll.mmio_write.argtypes = [ctypes.c_char_p, _F64P, ctypes.c_int64,
                                    ctypes.c_int64]

    def read_mtx(self, path) -> np.ndarray:
        """The dense f64 matrix of a MatrixMarket file (coordinate or
        array, real; symmetric and skew-symmetric coordinate files
        mirrored).  Raises ``OSError`` when the file cannot be read and
        ``ValueError`` when it cannot be parsed."""
        data = _F64P()
        rows, cols = ctypes.c_int64(), ctypes.c_int64()
        rc = self._lib.mmio_read(os.fsencode(path), ctypes.byref(data),
                                 ctypes.byref(rows), ctypes.byref(cols))
        if rc != 0:
            error = OSError if rc in (1, 2) else ValueError
            raise error(f"mmio_read({path}): "
                        f"{_MMIO_ERRORS.get(rc, f'code {rc}')}")
        try:
            n = rows.value * cols.value
            arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
        finally:
            self._lib.mmio_free(data)
        return arr.reshape(rows.value, cols.value)

    def write_mtx(self, path, a) -> None:
        """Write a 2-D array's nonzeros in coordinate format."""
        a = np.ascontiguousarray(a, dtype=np.float64)
        if a.ndim != 2:
            raise ValueError(f"write_mtx takes a 2-D array, got {a.shape}")
        rc = self._lib.mmio_write(os.fsencode(path), a.ctypes.data_as(_F64P),
                                  a.shape[0], a.shape[1])
        if rc != 0:
            raise OSError(f"mmio_write({path}) failed with code {rc}")


def get_mmio() -> Mmio:
    """The loaded MatrixMarket library, built at first use; raises when
    it cannot be built or loaded."""
    return _load("mmio", Mmio)


def read_mtx(path) -> np.ndarray:
    """:meth:`Mmio.read_mtx` of the loaded library."""
    return get_mmio().read_mtx(path)


def write_mtx(path, a) -> None:
    """:meth:`Mmio.write_mtx` of the loaded library."""
    get_mmio().write_mtx(path, a)
