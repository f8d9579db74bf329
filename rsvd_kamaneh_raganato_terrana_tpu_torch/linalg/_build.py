"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, ``build/lib<name>-<hash>.so`` inside
the package, and is loaded with ``ctypes``.  ``<hash>`` covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  All sources build in parallel, one ``nvcc`` each.  The build
needs ``nvcc`` for ``sm_90a`` (CUDA toolkit under ``$CUDA_HOME`` or
``/usr/local/cuda``) and nothing outside the package's own sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
build_logs: dict = {}   # name -> nvcc's output (ptxas register/smem report)


def find_nvcc():
    """Path of ``nvcc``, or None when no CUDA toolkit is installed."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def headers():
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path(src: Path) -> Path:
    """Library built from ``src``; its name hashes the source, every
    shared header in ``csrc/`` and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in headers():
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, src: Path, out: Path):
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all():
    """Compile every source whose library is missing, all at once; return
    the list of library paths."""
    todo = [(s, library_path(s)) for s in sources()]
    todo = [(s, p) for s, p in todo if not p.exists()]
    if todo:
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found: the CUDA kernels need the CUDA toolkit "
                "(sm_90a) on PATH or under $CUDA_HOME")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                nvcc_command(nvcc, src, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [library_path(s) for s in sources()]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(SRC_DIR / f"{name}.cu")
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
