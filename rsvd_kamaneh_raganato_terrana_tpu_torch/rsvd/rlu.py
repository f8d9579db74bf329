"""Randomized LU decomposition (RLU; the JAX package's ``rsvd/rlu.py``):
A[P][:, Q] ~ L U with P, Q row and column permutations, L m x l
lower-trapezoidal, U l x n upper-trapezoidal (Shabat, Shkolnisky,
Aizenbud & Averbuch 2018, Alg. 4.1 with the power iteration of
Alg. 4.4).

The range finder is the driver's ``subspace_iteration``; the two pivoted
LUs are ``torch.linalg.lu_factor`` of an m x l and an n x l panel; the
rest is one l x l Cholesky solve.  LAPACK returns its row pivots as a
1-based sequence of swaps, where ``jax.lax.linalg.lu`` returns the
permutation with A[perm] = L U; :func:`_swaps_to_perm` applies the swaps
to the identity on the device (l small index updates, no host sync).
Permutations are int64, where the JAX package's are int32 (torch
indexes with int64).  Every Cholesky follows XLA's failure contract
(NaN, ``core/device.py::cholesky``).

L_y^T (P A) is computed as (P^T L_y)^T A, L_y's rows put back in A's
order, so that a DTensor whose rows are sharded never moves: its local
rows' product is all-reduced.  The m x l range panel is gathered (one
counted all-gather) and its pivoted LU runs on every rank, as on one
card, so the row permutation does not depend on the split; L and L_y
come back row-sharded (their rows in the permuted order), the rest
replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import cholesky
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _row_block,
    _row_split,
    _to_api,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    subspace_iteration,
)


class RluResult(NamedTuple):
    """A[perm_rows][:, perm_cols] ~ l_factor @ u_factor.

    perm_rows: (m,) int64 -- row permutation (the gather indices P)
    perm_cols: (n,) int64 -- column permutation (the gather indices Q)
    l_factor:  (m, l) lower-trapezoidal
    u_factor:  (l, n) upper-trapezoidal with unit diagonal
    l_ortho:   (m, l) the unit-lower trapezoid of the orthonormal range
               panel's LU (l_factor = l_ortho @ u2.T), kept so that
               solves go through the two factors apart: l_ortho's Gram is
               well conditioned, l_factor's squares cond(u2).
    u2:        (l, l) upper-triangular second-LU factor
    """

    perm_rows: torch.Tensor
    perm_cols: torch.Tensor
    l_factor: torch.Tensor
    u_factor: torch.Tensor
    l_ortho: torch.Tensor
    u2: torch.Tensor


def _swaps_to_perm(pivots, m: int):
    """The permutation perm (int64, m) with A[perm] = L U from LAPACK's
    1-based row swaps (row i swapped with row pivots[i] - 1, in order)."""
    perm = torch.arange(m, device=pivots.device)
    swaps = pivots.to(torch.int64) - 1
    for i in range(swaps.shape[0]):
        j = swaps[i:i + 1]
        here, there = perm[i:i + 1].clone(), perm.index_select(0, j)
        perm[i:i + 1] = there
        perm.index_copy_(0, j, here)
    return perm


def _pivoted_lu(x):
    """(packed LU, perm) of a tall x with x[perm] = L U."""
    lu, pivots = torch.linalg.lu_factor(x)
    return lu, _swaps_to_perm(pivots, x.shape[0])


def _unit_lower(lu, rows: int, cols: int):
    return torch.tril(lu, -1) + torch.eye(rows, cols, dtype=lu.dtype,
                                          device=lu.device)


def rlu(a, k: int, p: int = 10, q: int = 2, seed: int = 0,
        precision: str = "highest") -> RluResult:
    """Randomized rank-l (l = k + p) LU: ``A[P][:, Q] ~ L @ U``.  Its
    error matches the rSVD range finder's for the same (k, p, q).
    :func:`rlu_reconstruct` returns to the original row and column order.
    A tensor stays on its device; any other array goes to the card; a
    DTensor whose rows are sharded is read block by block (the module
    docstring)."""
    a = _row_split(a)
    if len(a.shape) != 2:
        raise ValueError(f"rlu needs a 2-D matrix, got {tuple(a.shape)}")
    if a.dtype.is_complex:
        raise ValueError("rlu supports real input only")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    m, n = a.shape
    l = min(k + p, min(m, n))
    omega = driver.generate_omega(seed, n, l, a.dtype, device=a.device)
    q_mat = subspace_iteration(a, omega, q, precision=precision)  # m x l
    lu_y, perm_rows = _pivoted_lu(_whole(q_mat))    # Q[perm] = L_y U_y
    l_y = _unit_lower(lu_y, m, l)                   # m x l
    # B = L_y^+ (P A) by the l x l normal equations; L_y^T (P A) as
    # (P^T L_y)^T A
    g = _mm(l_y.T, l_y, "highest")
    c = cholesky(g)
    l_orig = torch.empty_like(l_y).index_copy_(0, perm_rows, l_y)
    b = torch.cholesky_solve(_mm(l_orig.T, a, precision), c)  # l x n
    # B^T[perm_cols] = L2 U2  =>  B[:, perm_cols] = U2^T L2^T
    lu_b, perm_cols = _pivoted_lu(b.T)
    l2 = _unit_lower(lu_b, n, l)                    # n x l
    u2 = torch.triu(lu_b[:l, :])                    # l x l
    l_rows = _row_block(a, l_y)                     # this rank's rows
    l_factor = _mm(l_rows, u2.T, "highest")         # m x l, lower
    return RluResult(perm_rows, perm_cols, _to_api(_like(a, l_factor)),
                     l2.T, _to_api(_like(a, l_rows)), u2)


def rlu_reconstruct(res: RluResult):
    """A ~ P^T (L U) Q^T in the original row and column order."""
    prod = _mm(res.l_factor, res.u_factor, "highest")
    inv_rows = torch.argsort(res.perm_rows)
    inv_cols = torch.argsort(res.perm_cols)
    return prod[inv_rows, :][:, inv_cols]


def rlu_solve(res: RluResult, b):
    """Least-squares solve of A x ~ b through the RLU factors, factor by
    factor: L = l_ortho @ u2^T, so L^+ b = u2^{-T} (l_ortho^+ b) (the
    normal equations see only the well-conditioned l_ortho, u2 gets a
    triangular solve); then the leading l x l block of U is
    back-substituted and the trailing unknowns set to zero (the basic
    solution, exact when rank(A) <= l)."""
    b = as_tensor(b, device=res.l_factor.device, dtype=res.l_factor.dtype)
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    l_o, u_f = res.l_ortho, res.u_factor
    lsz = l_o.shape[1]
    bp = b[res.perm_rows, :]
    c = cholesky(_mm(l_o.T, l_o, "highest"))
    w = torch.cholesky_solve(_mm(l_o.T, bp, "highest"), c)   # l x nrhs
    y = torch.linalg.solve_triangular(res.u2.T, w, upper=False)
    x1 = torch.linalg.solve_triangular(u_f[:, :lsz], y, upper=True)
    xq = torch.cat([x1, x1.new_zeros((u_f.shape[1] - lsz,)
                                     + tuple(x1.shape[1:]))], dim=0)
    # column j of the permuted system is original column perm_cols[j]
    x = torch.zeros_like(xq)
    x[res.perm_cols, :] = xq
    return x[:, 0] if squeeze else x
