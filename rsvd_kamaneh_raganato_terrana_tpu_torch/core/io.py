"""MatrixMarket I/O and the PCA datasets' loader (the JAX package's
``core/io.py``, copied: that package's ``__init__`` imports jax).

Dense ndarrays in, coordinate-format files out, in the layout of Eigen's
saveMarket.  ``read_matrix_market`` reads through the native parser
(``native/mmio.cpp``, built at first use); ``_read_python`` is the plain
NumPy parser it is held to in the tests.  Unlike the JAX package, a
failed build or parse raises instead of falling back to NumPy.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from rsvd_kamaneh_raganato_terrana_tpu_torch.native import read_mtx

_HEADER = "%%MatrixMarket matrix coordinate real general"


def _read_python(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().decode()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        tokens = [t.lower() for t in header.split()]
        fmt = tokens[2] if len(tokens) > 2 else "coordinate"
        symmetry = tokens[4] if len(tokens) > 4 else "general"
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise ValueError(f"{path}: unsupported symmetry {symmetry!r}")
        if fmt == "array" and symmetry != "general":
            # conforming array-symmetric files store a packed triangle,
            # which neither reader implements — fail loudly, don't guess
            raise ValueError(
                f"{path}: array-format symmetric files are not supported "
                "(packed-triangle layout); convert to coordinate format"
            )
        line = f.readline().decode()
        while line.startswith("%"):
            line = f.readline().decode()
        dims = line.split()
        if fmt == "array":
            rows, cols = int(dims[0]), int(dims[1])
            data = np.loadtxt(f, dtype=np.float64)
            out = np.asarray(data).reshape(cols, rows).T  # column-major
            return _apply_symmetry(out, symmetry)
        rows, cols = int(dims[0]), int(dims[1])
        entries = np.loadtxt(f, dtype=np.float64, ndmin=2)
        out = np.zeros((rows, cols), dtype=np.float64)
        if entries.size:
            i = entries[:, 0].astype(np.int64) - 1
            j = entries[:, 1].astype(np.int64) - 1
            v = entries[:, 2] if entries.shape[1] > 2 else np.ones(len(i))
            out[i, j] = v
        return _apply_symmetry(out, symmetry)


def _apply_symmetry(out: np.ndarray, symmetry: str) -> np.ndarray:
    """Mirror the stored triangle for symmetric/skew-symmetric coordinate
    files.  Only positions whose opposite entry is zero are filled, so a
    (non-conforming) file that stored both triangles is not doubled —
    matching the native parser's semantics."""
    if symmetry == "general":
        return out
    sign = -1.0 if symmetry == "skew-symmetric" else 1.0
    mirror = np.where((out == 0) & (out.T != 0), sign * out.T, 0.0)
    np.fill_diagonal(mirror, 0.0)
    return out + mirror


def read_matrix_market(path: str, dtype=None) -> np.ndarray:
    """Read a dense matrix from a MatrixMarket file (coordinate or array),
    as f64 numpy unless ``dtype`` is given."""
    out = read_mtx(path)
    if dtype is not None:
        out = out.astype(dtype)
    return out


def write_matrix_market(path: str, a, comment: str = "") -> None:
    """Write a dense matrix (or vector) in coordinate format, matching the
    layout Eigen's saveMarket emits so the reference's comparator scripts
    (python/compare_rSVD.py) can consume our outputs unmodified."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    rows, cols = a.shape
    i, j = np.nonzero(a)
    v = a[i, j]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(_HEADER + "\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{rows} {cols} {len(v)}\n")
        lines = "\n".join(
            f"{ii + 1} {jj + 1} {vv:.18e}" for ii, jj, vv in zip(i, j, v)
        )
        if lines:
            f.write(lines + "\n")


def load_whitespace_dataset(
    path: str, skip_cols: int = 0, skip_header: bool = True
) -> Tuple[np.ndarray, list]:
    """Whitespace-delimited numeric dataset loader with leading categorical
    columns skipped — the reference's PCA loaders (PCA/main/main.cpp:5-43,
    PCA/tests/pca_test.cpp:8-59) hand-rolled this per file; we generalize.

    Returns (data, row_labels) where row_labels holds the skipped leading
    fields of each row (joined by space).
    """
    rows, labels = [], []
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if skip_header:
        lines = lines[1:]
    for ln in lines:
        parts = _split_quoted(ln)
        labels.append(" ".join(parts[:skip_cols]))
        rows.append([float(x) for x in parts[skip_cols:]])
    return np.asarray(rows, dtype=np.float64), labels


def _split_quoted(line: str) -> list:
    out, cur, quoted = [], [], False
    for ch in line:
        if ch == '"':
            quoted = not quoted
        elif ch.isspace() and not quoted:
            if cur:
                out.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out
