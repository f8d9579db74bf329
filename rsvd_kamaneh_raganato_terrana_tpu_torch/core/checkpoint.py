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
same-named type here, its arrays as tensors on ``device``.

:func:`save_factors_dcp`/:func:`load_factors_dcp` are the counterpart of
the JAX package's orbax pair (``save_factors_orbax``/
``load_factors_orbax``): a directory written by
``torch.distributed.checkpoint``, each rank writing its own rows of a
row-sharded U.  They read no orbax directory (another format).
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import warnings
from contextlib import contextmanager
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


_FACTOR_META = "factor_meta.json"


def _dcp_rank():
    """(no_dist, rank): this process alone unless a process group is
    up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return False, dist.get_rank()
    return True, 0


@contextmanager
def _one_process_quiet():
    """DCP warns on every call in one process that it assumes one
    process; here that is the contract."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield


def save_factors_dcp(path: str, U, S, V, meta: Optional[Dict] = None) -> None:
    """Save an SVD factor triple to the directory ``path`` with
    ``torch.distributed.checkpoint`` (the counterpart of the JAX
    package's ``save_factors_orbax``, ``core/checkpoint.py:46-74``).

    ``U`` is a tensor, on the card or on the host, or the row-sharded
    DTensor that ``rsvd`` returns on a sharded operand: each rank writes
    its own rows, nothing is gathered.  ``S`` and ``V`` are tensors every
    rank holds whole (written once).  With a process group up every rank
    calls.  An existing ``path`` is replaced; ``meta`` goes to
    ``factor_meta.json``, written by rank 0.  Returns once every file is
    written."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    no_dist, rank = _dcp_rank()
    if rank == 0 and os.path.isdir(path):
        shutil.rmtree(path)
    if not no_dist:
        dist.barrier()
    with _one_process_quiet():
        dcp.save({"U": U, "S": S, "V": V}, checkpoint_id=path,
                 no_dist=no_dist)
    if meta and rank == 0:
        with open(os.path.join(path, _FACTOR_META), "w") as f:
            json.dump(meta, f)
    if not no_dist:
        dist.barrier()


def load_factors_dcp(path: str, *, mesh=None, device=None):
    """Inverse of :func:`save_factors_dcp` (the JAX package's
    ``load_factors_orbax``): ``(U, S, V, meta)``, bitwise what was saved,
    dtypes kept, shapes and dtypes read from the checkpoint's metadata.

    With ``mesh`` (every rank of the process group calls) U comes back
    as a row-sharded DTensor on it, whatever the world size was at save
    time, and S and V as tensors on the mesh's device type.  Without,
    this process alone reads three tensors on ``device`` (the card
    unless the caller names another).  ``meta`` is ``{}`` when the
    checkpoint has no ``factor_meta.json``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    path = os.path.abspath(path)
    stored = FileSystemReader(path).read_metadata().state_dict_metadata

    def empty(key, dev):
        md = stored[key]
        return torch.empty(md.size, dtype=md.properties.dtype, device=dev)

    if mesh is None:
        dev = torch.device(device or "cuda")
        state = {key: empty(key, dev) for key in ("U", "S", "V")}
    else:
        from torch.distributed.tensor import empty as dtensor_empty

        from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
            row_spec_for,
        )

        md = stored["U"]
        dev = torch.device(mesh.device_type)
        state = {"U": dtensor_empty(*md.size, dtype=md.properties.dtype,
                                    device_mesh=mesh,
                                    placements=row_spec_for(mesh)),
                 "S": empty("S", dev), "V": empty("V", dev)}
    with _one_process_quiet():
        dcp.load(state, checkpoint_id=path, no_dist=mesh is None)
    meta_path = os.path.join(path, _FACTOR_META)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state["U"], state["S"], state["V"], meta


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
