"""Factor-table checkpointing (the JAX package's ``core/checkpoint.py``,
copied: that package's ``__init__`` imports jax).

U, S, V (+ metadata) as a single ``.npz``, the tensor formats' factors
(Tucker, TT, CP) likewise, fitted NamedTuple models (``Deim``,
``HodlrMatrix``, ``CompletionResult``, ...) with their tree recorded,
and MatrixMarket export for the oracle-comparison harness.  The files
are the JAX package's, byte layout and keys alike; tensors are copied to
the host (bf16 widened to f32) before they are written.

``load_model`` rebuilds the recorded NamedTuple type from this package:
a file the JAX package wrote, which records a JAX module, loads as the
same-named type here, its arrays as tensors on ``device``.  The JAX
package's orbax pair (``save_factors_orbax``/``load_factors_orbax``)
stores JAX arrays and stays JAX-only.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
    from_numpy,
    to_numpy,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.io import (
    write_matrix_market,
)

_PKG = __name__.split(".")[0]
_JAX_PKG = _PKG[:-len("_torch")]


def _host(x) -> np.ndarray:
    """A numpy array of ``x``: tensors are copied to the host first."""
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; normalize in both save and
    load so save_factors('foo') / load_factors('foo') round-trip."""
    return path if path.endswith(".npz") else path + ".npz"


def _make_parent(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_factors(path: str, U, S, V, meta: Optional[Dict] = None) -> None:
    """Save an SVD factor triple to ``path`` (.npz)."""
    path = _npz_path(path)
    _make_parent(path)
    np.savez_compressed(path, U=_host(U), S=_host(S), V=_host(V),
                        meta=json.dumps(meta or {}))


def load_factors(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict]:
    """Inverse of :func:`save_factors`: host (U, S, V, meta)."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        return z["U"], z["S"], z["V"], json.loads(str(z["meta"]))


def save_tensor_factors(path: str, kind: str, *, core=None, factors=None,
                        cores=None, weights=None,
                        meta: Optional[Dict] = None) -> None:
    """One-file (.npz) persistence for the tensor formats:

    - ``kind='tucker'``: pass ``core`` + ``factors`` (sequence)
    - ``kind='tt'``:     pass ``cores`` (sequence)
    - ``kind='cp'``:     pass ``weights`` + ``factors`` (sequence)

    Round-trips through :func:`load_tensor_factors`."""
    path = _npz_path(path)
    arrays: Dict[str, np.ndarray] = {}
    if kind == "tucker":
        if core is None:
            raise ValueError("kind='tucker' needs core")
        arrays["core"] = _host(core)
        seq = factors
    elif kind == "tt":
        seq = cores
    elif kind == "cp":
        if weights is None:
            raise ValueError("kind='cp' needs weights")
        arrays["weights"] = _host(weights)
        seq = factors
    else:
        raise ValueError(f"unknown kind {kind!r}")
    if seq is None:
        raise ValueError(f"kind={kind!r} needs its factor sequence")
    seq = list(seq)
    for i, f in enumerate(seq):
        arrays[f"f{i}"] = _host(f)
    _make_parent(path)
    np.savez_compressed(path, kind=kind, n_factors=len(seq),
                        meta=json.dumps(meta or {}), **arrays)


def load_tensor_factors(path: str):
    """Inverse of :func:`save_tensor_factors`.  Returns a dict with
    ``kind``, ``meta``, and the format's fields (``core``+``factors``,
    ``cores``, or ``weights``+``factors``) as host arrays."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        kind = str(z["kind"])
        seq = tuple(z[f"f{i}"] for i in range(int(z["n_factors"])))
        out = {"kind": kind, "meta": json.loads(str(z["meta"]))}
        if kind == "tucker":
            out.update(core=z["core"], factors=seq)
        elif kind == "tt":
            out.update(cores=seq)
        else:
            out.update(weights=z["weights"], factors=seq)
        return out


def save_model(path: str, model, meta: Optional[Dict] = None) -> None:
    """One-file (.npz) persistence for the fitted model objects -- any
    NamedTuple of tensors/arrays/ints (``rsvd.deim.Deim``,
    ``rsvd.hodlr.HodlrMatrix``, ``rsvd.completion.CompletionResult``,
    ...).  Nested tuples of arrays (HODLR's per-level factor stacks) are
    flattened with their tree recorded in the metadata; round-trips
    through :func:`load_model`."""
    cls = type(model)
    if not hasattr(model, "_fields"):
        raise TypeError(f"save_model needs a NamedTuple, got {cls}")
    path = _npz_path(path)
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict[str, object] = {}
    lengths: Dict[str, int] = {}
    for name in model._fields:
        val = getattr(model, name)
        if isinstance(val, (tuple, list)):
            lengths[name] = len(val)
            for i, item in enumerate(val):
                arrays[f"{name}__{i}"] = _host(item)
        elif isinstance(val, (int, float, bool, str)):
            scalars[name] = val
        else:
            arrays[name] = _host(val)
    header = {
        "class_module": cls.__module__,
        "class_name": cls.__qualname__,
        "fields": list(model._fields),
        "tuple_lengths": lengths,
        "scalars": scalars,
        "meta": meta or {},
    }
    _make_parent(path)
    np.savez_compressed(path, __model__=json.dumps(header), **arrays)


def _port_module(name: str) -> str:
    """The module of this package that mirrors ``name``: a module of the
    JAX package maps to its counterpart here."""
    head, _, rest = name.partition(".")
    return f"{_PKG}.{rest}" if head == _JAX_PKG else name


def load_model(path: str, device=None):
    """Inverse of :func:`save_model`: returns ``(model, meta)`` with the
    recorded NamedTuple type of this package and its arrays as tensors on
    ``device`` (the card unless the caller names another)."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        header = json.loads(str(z["__model__"]))
        cls = importlib.import_module(_port_module(header["class_module"]))
        for part in header["class_name"].split("."):
            cls = getattr(cls, part)
        values = []
        for name in header["fields"]:
            if name in header["tuple_lengths"]:
                n = header["tuple_lengths"][name]
                values.append(tuple(from_numpy(z[f"{name}__{i}"], device)
                                    for i in range(n)))
            elif name in header["scalars"]:
                values.append(header["scalars"][name])
            else:
                values.append(from_numpy(z[name], device))
        return cls(*values), header["meta"]


def export_matrix_market(out_dir: str, stem: str, U, S, V) -> None:
    """Reference-layout export: <stem>_U.mtx / _S.mtx / _V.mtx under
    out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    for suffix, x in (("U", U), ("S", S), ("V", V)):
        write_matrix_market(os.path.join(out_dir, f"{stem}_{suffix}.mtx"),
                            _host(x))
