"""Discrete Empirical Interpolation Method (DEIM / Q-DEIM), the JAX
package's ``rsvd/deim.py``.

Given an orthonormal basis U (n x m) for a nonlinearity's snapshots,
select m interpolation rows P and approximate

    f  ~  U (P^T U)^{-1} P^T f,

so the online cost of the nonlinear term is m point evaluations of f
plus an (n x m) GEMV (Chaturantabut & Sorensen 2010).  The ROM that
uses it is ``apps/rom.py::solve_rom_deim``.

Index selection:

- ``qdeim`` (default): column-pivoted-QR pivots of U^T (Drmac &
  Gugercin 2016), by the greedy sketch-space pivoting of
  ``rsvd/interp.py::_greedy_pivots``.
- ``deim``: the classic greedy (interpolate with the first j basis
  vectors, pick the row of max |residual| of vector j), with the growing
  j x j systems written as identity-padded m x m solves, as in the JAX
  package.

Indices are int64 tensors on the basis' device.

The basis may be a DTensor whose rows are sharded (``deim_fit`` of
row-sharded snapshots makes one), read by its rows and never gathered:
each pivot's argmax is local, then global by one all-reduce of the
ranks' (value, index) pairs, ties to the lower index as on one card
(``rsvd/_sharded.py::_argmax``); the selected rows of U come from the
ranks that hold them (``_take_rows``), the small m x m solves run
replicated, and the projector comes back row-sharded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _argmax,
    _like,
    _local,
    _row_split,
    _take_rows,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    rsvd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.interp import _greedy_pivots


def _classic_deim_indices(u):
    """Chaturantabut-Sorensen greedy: row of max |residual| per basis
    vector, residual from interpolating with the bases selected so far.
    A row-split ``u`` (:class:`Sharded`) takes each argmax over the ranks
    and the selected rows from the ranks that hold them."""
    m = u.shape[1]
    local = _local(u)
    idx = torch.zeros((m,), dtype=torch.int64, device=local.device)
    idx[0] = _argmax(torch.abs(local[:, 0]), u)
    eye = torch.eye(m, dtype=local.dtype, device=local.device)
    ar = torch.arange(m, device=local.device)
    for j in range(1, m):
        sel = ar < j
        rows = _take_rows(u, idx)                    # m x m (rows >= j dummy)
        mat = torch.where(sel[:, None] & sel[None, :], rows, eye)
        rhs = torch.where(sel, rows[:, j], torch.zeros_like(rows[:, j]))
        c = torch.linalg.solve(mat, rhs)             # zero beyond row j
        r = local[:, j] - _mm(local, c[:, None])[:, 0]
        idx[j] = _argmax(torch.abs(r), u)
    return idx


def deim_indices(u, method: str = "qdeim") -> torch.Tensor:
    """m interpolation row indices for the orthonormal basis ``u``
    (n x m).  ``method``: 'qdeim' (pivoted-QR selection, default) or
    'deim' (classic greedy).  A row-sharded ``u`` is read by its rows
    (the module docstring); the indices equal the single call's."""
    u = _row_split(u)
    if method == "qdeim":
        return _greedy_pivots(_local(u).T, u.shape[1], u)
    if method == "deim":
        return _classic_deim_indices(u)
    raise ValueError(f"unknown DEIM index method: {method!r}")


def deim_projector(u, idx) -> torch.Tensor:
    """The oblique projector factor  U (P^T U)^{-1}  (n x m): interpolate
    a full vector f with ``proj @ f[idx]``.  A row-sharded ``u`` gives
    the projector row-sharded alike."""
    u = _row_split(u)
    pu = _take_rows(u, as_tensor(idx, _local(u).device))    # m x m
    return _to_api(_like(u, torch.linalg.solve(pu.T, _local(u).T).T))


class Deim(NamedTuple):
    """A fitted DEIM model: ``interpolate(f) = proj @ f[indices]``."""

    basis: torch.Tensor       # n x m orthonormal snapshot basis U
    indices: torch.Tensor     # int64[m] interpolation rows P
    proj: torch.Tensor        # n x m oblique projector U (P^T U)^{-1}


def deim_interpolate(d: Deim, f) -> torch.Tensor:
    """Interpolate full-order vector(s) ``f`` (n,) or (n, batch) from
    their values at the m DEIM rows."""
    f = as_tensor(f, d.proj.device)
    picked = f.index_select(0, d.indices)
    if picked.ndim == 1:
        return _mm(d.proj, picked[:, None])[:, 0]
    return _mm(d.proj, picked)


def deim_condition(u, idx) -> torch.Tensor:
    """||(P^T U)^{-1}||_2 = 1/sigma_min(P^T U): the DEIM error
    amplification factor,  ||f - DEIM(f)|| <= cond * ||(I-UU^T) f||."""
    u = _row_split(u)
    pu = _take_rows(u, as_tensor(idx, _local(u).device))
    return 1.0 / torch.linalg.svdvals(pu)[-1]


def deim_fit(
    snapshots,
    m: int,
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    method: str = "qdeim",
) -> Deim:
    """Fit a DEIM model from nonlinearity snapshots (n x n_snap): rank-m
    rSVD basis (the snapshot count never touches the online cost), then
    index selection + projector.  Row-sharded snapshots give a
    row-sharded basis and projector (the module docstring)."""
    u, _, _ = rsvd(_row_split(snapshots), k=m, p=p, q=q, seed=seed,
                   method="eigh")
    idx = deim_indices(u, method)
    return Deim(u, idx, deim_projector(u, idx))
