"""Whether the timed path's factors are correct: the sampled calls'
(U, s, V) against the plain f64 reference on the same operand and
sketch (``reference/``), each number held to the cell's limit.

:func:`readings` gives the numbers of the program's samples; given a
second view of the operand at the cell's control precision, also those
of the reference itself computed one precision lower in the program's
place (``control.py``).
"""

from __future__ import annotations

import math

from portbench import operands
from portbench.reference import compare, rsvd_f64
from portbench.reference.operand import Comm, DenseRef, SparseRef

REF_BLOCK_ROWS = 4096


def worst(a, b):
    """The larger of two readings; NaN wins."""
    if a is None or (isinstance(b, float) and math.isnan(b)):
        return b
    if isinstance(a, float) and math.isnan(a):
        return a
    return max(a, b)


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
                    else worst(acc.get(key), val))


def readings(wl: dict, cfg: dict, samples, ref_view, device,
             control_view=None):
    """{number: worst reading over the samples} of the program's
    factors.  ``samples``: dicts with the call's sketch ``seed`` and its
    factors ``u`` (this rank's rows), ``s``, ``v`` and ``health``.  With
    ``control_view`` (the reference at the control's numerics) also the
    control's readings on each sample's sketch: (program, control)."""
    finish = wl["reference"]["finish"]
    k = cfg["settings"]["k"]
    comm = ref_view.comm
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
    return prog if control_view is None else (prog, ctl)


def verdict(limits: dict, found: dict):
    """(correct, [(name, value, limit)]): each number at or under its
    limit (a missing or NaN reading fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = found.get(name, float("nan"))
        rows.append((name, value, limit))
        ok = ok and value <= limit
    return ok, rows
