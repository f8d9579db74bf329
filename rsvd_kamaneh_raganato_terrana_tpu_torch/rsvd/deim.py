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

``deim_fit`` takes a DTensor whose rows are sharded: the rSVD basis
comes back row-sharded, the n x m basis is gathered (one counted
all-gather) and the indices selected on every rank as on one card, and
the projector keeps each rank's rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _row_block,
    _row_split,
    _sharded_view,
    _to_api,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    rsvd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.interp import _greedy_pivots


def _classic_deim_indices(u):
    """Chaturantabut-Sorensen greedy: row of max |residual| per basis
    vector, residual from interpolating with the bases selected so far."""
    m = u.shape[1]
    idx = torch.zeros((m,), dtype=torch.int64, device=u.device)
    idx[0] = torch.argmax(torch.abs(u[:, 0]))
    eye = torch.eye(m, dtype=u.dtype, device=u.device)
    ar = torch.arange(m, device=u.device)
    for j in range(1, m):
        sel = ar < j
        rows = u.index_select(0, idx)                # m x m (rows >= j dummy)
        mat = torch.where(sel[:, None] & sel[None, :], rows, eye)
        rhs = torch.where(sel, rows[:, j], torch.zeros_like(rows[:, j]))
        c = torch.linalg.solve(mat, rhs)             # zero beyond row j
        r = u[:, j] - _mm(u, c[:, None])[:, 0]
        idx[j] = torch.argmax(torch.abs(r))
    return idx


def deim_indices(u, method: str = "qdeim") -> torch.Tensor:
    """m interpolation row indices for the orthonormal basis ``u``
    (n x m).  ``method``: 'qdeim' (pivoted-QR selection, default) or
    'deim' (classic greedy)."""
    u = as_tensor(u)
    if method == "qdeim":
        return _greedy_pivots(u.T, u.shape[1])
    if method == "deim":
        return _classic_deim_indices(u)
    raise ValueError(f"unknown DEIM index method: {method!r}")


def deim_projector(u, idx) -> torch.Tensor:
    """The oblique projector factor  U (P^T U)^{-1}  (n x m): interpolate
    a full vector f with ``proj @ f[idx]``."""
    u = as_tensor(u)
    pu = u.index_select(0, idx)                      # m x m
    return torch.linalg.solve(pu.T, u.T).T


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
    pu = as_tensor(u).index_select(0, idx)
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
    view = _sharded_view(u)
    whole = _whole(view)
    idx = deim_indices(whole, method)
    proj = deim_projector(whole, idx)
    return Deim(u, idx, _to_api(_like(view, _row_block(view, proj))))
