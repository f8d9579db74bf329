"""The program's side of set-up: its kernels loaded, its operand built
from the benchmark's inputs with its own functions (the system under
test), and its entry called.  Every program name comes from the cell's
files (``module:attribute``)."""

from __future__ import annotations

import importlib

import torch

from portbench import operands

PKG = "rsvd_kamaneh_raganato_terrana_tpu_torch"


def resolve(target: str):
    """The attribute a ``module:attribute`` string names."""
    mod, attr = target.split(":")
    return getattr(importlib.import_module(mod), attr)


def load_kernels() -> int:
    """Build what is missing (the first run in a checkout compiles into
    the package's fixed ``build/`` directory) and load every kernel
    library; returns how many."""
    build = importlib.import_module(PKG + ".linalg._build")
    build.build_all()
    srcs = build.sources()
    for src in srcs:
        build.library(src.stem)
    return len(srcs)


def row_dtensor(local: torch.Tensor, rows: int, mesh):
    """A DTensor whose rows are split over the 1-D ``mesh`` in rank
    order, this rank holding ``local``; nothing is sent."""
    from torch.distributed.tensor import DTensor, Shard

    shape = (rows,) + tuple(local.shape[1:])
    return DTensor.from_local(local, mesh, (Shard(0),), run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def build(wl: dict, cfg: dict, seed: int, device, rank: int = 0, mesh=None):
    """(operand the entry reads, input the reference may read again):
    the second is the benchmark-made dense tensor where the program reads
    it as it is, else None (the reference makes its input again)."""
    op, form = cfg["operand"], wl["form"]
    if form == "dense":
        a = operands.planted_part(op, seed, 0, device)
        return a, a
    if form == "row_sharded":
        a = operands.planted_part(op, seed, rank, device)
        return row_dtensor(a, op["rows"], mesh), a
    if form == "int8_rows":
        # the program's per-row rule, applied block by block (the whole
        # f32 A and its quantization temporaries would not fit beside
        # each other), the blocks' codes and scales then held as one
        prepare = resolve(wl["prepare"])
        rows = operands.part_rows(op)
        q8 = torch.empty(rows, op["cols"], dtype=torch.int8, device=device)
        scales = []
        scratch = torch.empty(op["block_rows"], op["cols"], device=device)
        for r0, blk in operands.planted_blocks(op, seed, 0, device,
                                               scratch):
            st = prepare(blk)
            q8[r0:r0 + blk.shape[0]] = st.q8
            scales.append(st.row_scale)
            del st
        del scratch
        # the program's stored-operand class the cell names
        return resolve(wl["stored"])(q8, torch.cat(scales)), None
    if form == "sparse":
        idx, vals, shape = operands.ml20m(op, seed, device)
        coo = torch.sparse_coo_tensor(idx, vals, shape,
                                      check_invariants=False)._coalesced_(True)
        stored = resolve(wl["prepare"])(coo)
        return stored, None
    raise ValueError(f"unknown operand form {form!r}")

