"""Kind ``rsvd``: a matrix in, ``(U, s, V[, health])`` out, held to the
plain f64 rSVD on the same operand and sketch (``reference/rsvd_f64.py``).

The workload's ``form`` says how the operand is held: ``dense`` (the
planted f32 matrix), ``row_sharded`` (its rows split over the ranks as
a DTensor), ``int8_rows`` (the serving storage, quantized block by block
with the program's ``prepare``) or ``sparse`` (the ML-20M-shaped CSR the
program's ``prepare`` stores).  A workload that names no ``kind`` is of
this one.
"""

from __future__ import annotations

import torch

from portbench import check, operands, roofline
from portbench.forms import resolve
from portbench.reference import compare, rsvd_f64
from portbench.reference.operand import Comm, DenseRef, SparseRef

REF_BLOCK_ROWS = 4096


# -- the program's operand ------------------------------------------------

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


# -- one call's output ----------------------------------------------------

def sample(out):
    """(factors kept for the check, 0-d non-finite flag on the device,
    whether ``factor_health`` tripped in 'warn' mode)."""
    u, sv, v = out[0], out[1], out[2]
    u = u.to_local() if hasattr(u, "to_local") else u
    health = out[3] if len(out) > 3 else None
    bad = ~torch.isfinite(u.sum() + sv.sum() + v.sum())
    return (dict(u=u, s=sv, v=v, health=health), bad,
            health is not None and not health["ok"])


# -- the reference --------------------------------------------------------

def view(wl: dict, cfg: dict, seed: int, held, device, comm: Comm,
         numerics: str):
    """The reference's operand at ``numerics``: the held dense tensor
    (this rank's rows) read in blocks, or the operand made again from
    the seed."""
    op = cfg["operand"]
    if wl["form"] == "sparse":
        idx, vals, shape = operands.ml20m(op, seed, device)
        return SparseRef(idx, vals, shape, numerics)
    if held is None:
        held = operands.planted_part(op, seed, comm.rank, device)
    rows = held.shape[0]

    def blocks():
        for r0 in range(0, rows, REF_BLOCK_ROWS):
            yield r0, held[r0:r0 + REF_BLOCK_ROWS]
    return DenseRef(blocks, rows, op["cols"], numerics, comm)


def _local_rows(u, comm: Comm, rows_local: int):
    if comm.size == 1:
        return u
    return u[comm.rank * rows_local:(comm.rank + 1) * rows_local]


def factors_of(ref_view, sketch_seed: int, cfg: dict, finish: str, device):
    """The reference's l components for one call's sketch seed."""
    s = cfg["settings"]
    l = s["k"] + s["p"]
    omega = rsvd_f64.draw_omega(sketch_seed, ref_view.cols, l, device)
    return rsvd_f64.rsvd(ref_view, omega, s["q"], finish)


def gaps(k, u, s, v, health, ur, sr, vr, comm) -> dict:
    """Every number of ``reference/compare.py`` for one call: the
    program's k components against the reference's l (``gap_at_k``, the
    reference's relative gap at the cut, is a diagnosis, not compared)."""
    k0 = compare.lead_cut(sr, k)
    out = {"s_gap": compare.s_gap(s, sr[:k]),
           "s_rms": compare.s_rms(s, sr[:k]),
           "factor_gap": compare.factor_gap(u, s, v, ur[:, :k], sr[:k],
                                            vr[:, :k], comm),
           "lead_gap": compare.factor_gap(u[:, :k0], s[:k0], v[:, :k0],
                                          ur[:, :k0], sr[:k0], vr[:, :k0],
                                          comm),
           "gap_at_k": float((sr[k - 1] - sr[k]) / sr[k - 1]),
           "lead_k": float(k0)}
    plain = compare.health(u, s, v)
    said = plain if health is None else bool(health["ok"])
    out["health_mismatch"] = float(said != plain)
    return out


def _fold(acc: dict, new: dict):
    for key, val in new.items():
        acc[key] = (min(acc[key], val) if key == "gap_at_k" and key in acc
                    else check.worst(acc.get(key), val))


def readings(wl: dict, cfg: dict, samples, held, seed: int, device,
             comm: Comm, control=None):
    """{number: worst reading over the samples} of the program's
    factors against the reference at the cell's ``reference.operand``
    numerics.  ``samples``: dicts with the call's sketch ``seed`` and
    :func:`sample`'s factors (``u`` this rank's rows).  With ``control``
    (the control's numerics) also the readings of the reference itself
    computed at those numerics on each sample's sketch, in the program's
    place: (program, control)."""
    ref = wl["reference"]
    if held is None and wl["form"] != "sparse":
        # made once for both views
        held = operands.planted_part(cfg["operand"], seed, comm.rank,
                                     device)
    ref_view = view(wl, cfg, seed, held, device, comm, ref["operand"])
    control_view = (None if control is None else
                    view(wl, cfg, seed, held, device, comm, control))
    finish = ref["finish"]
    k = cfg["settings"]["k"]
    rows_local = ref_view.m // comm.size
    prog, ctl = {}, {}
    for smp in samples:
        ur, sr, vr = factors_of(ref_view, smp["seed"], cfg, finish, device)
        ur = _local_rows(ur, comm, rows_local)
        _fold(prog, gaps(k, smp["u"], smp["s"], smp["v"], smp["health"],
                         ur, sr, vr, comm))
        if control_view is not None:
            uc, sc, vc = factors_of(control_view, smp["seed"], cfg, finish,
                                    device)
            _fold(ctl, gaps(k, _local_rows(uc, comm, rows_local)[:, :k],
                            sc[:k], vc[:, :k], None, ur, sr, vr, comm))
            del uc, sc, vc
        del ur, sr, vr
    return prog if control is None else (prog, ctl)


# -- least time -----------------------------------------------------------

def least(wl: dict, cfg: dict, world: int):
    """(least seconds, 'operations' or 'bytes') of one call's passes over
    one card's part of A (``roofline.products_least``)."""
    s, op = cfg["settings"], cfg["operand"]
    if op["kind"] == "ml20m":
        m, n, nnz = op["users"], op["items"], op["ratings"]
    else:                                   # one card's rows of A
        m, n, nnz = operands.part_rows(op), op["cols"], 0
    t, by, _, _ = roofline.products_least(wl["products"], m, n,
                                          s["k"] + s["p"], nnz)
    return t, by
