"""Randomized factorizations of symmetric and positive-semidefinite
matrices (the JAX package's ``rsvd/nystrom.py``):

- ``nystrom_psd``: the single-pass stabilized Nystrom approximation
  (Tropp, Yurtsever, Udell & Cevher 2017, Alg. 3): one GEMM against A,
  then a shift, a Cholesky, a triangular solve and an l x l eigh.
- ``reigh`` / ``reigh_generalized``: randomized truncated (generalized)
  eigendecomposition of a symmetric matrix by the rSVD range finder and
  Rayleigh-Ritz projection (Halko-Martinsson-Tropp 2011, Alg. 5.3).
- ``nystrom_pcg``: CG on (A + mu I) x = b preconditioned by the Nystrom
  approximation (Frangella, Tropp & Udell 2023, Alg. 3).

Every Cholesky follows XLA's failure contract (``core/device.py::
cholesky``: NaN where it fails, read from ``info`` on the device), and
the small eighs go through ``core/device.py::eigh``.  Omega comes from
the driver's ``generate_omega`` on A's device.

``nystrom_psd`` takes a DTensor whose rows are sharded: Y = A Omega and
B stay row-split, the l x l products are the driver's split products,
all-reduced, and Omega is drawn whole, as on one card; U comes back
row-sharded.
"""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    eigh,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _cols,
    _like,
    _local,
    _mm,
    _reduce,
    _row_block,
    _row_split,
    _to_api,
    subspace_iteration,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.lstsq import _pcg_scan


def _eigh_descending(t):
    """eigh with eigenvalues sorted descending (eigh returns ascending)."""
    w, v = eigh(t)
    return w.flip(0), v.flip(1)


def _check_square(a, name):
    if len(a.shape) != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{name} needs a square matrix, got "
                         f"{tuple(a.shape)}")


def _nystrom_impl(a, *, k, p, seed, precision):
    n = a.shape[0]
    l = min(k + p, n)
    omega = driver.generate_omega(seed, n, l, a.dtype, device=a.device)
    y = _mm(a, omega, precision)                         # one pass over A
    # Stabilizing shift: nu ~ eps ||Y||_F makes Omega^T (Y + nu Omega)
    # positive definite even for a numerically rank-deficient A; it is
    # taken off the eigenvalues at the end.
    y_local = _local(y)
    nu = torch.finfo(a.dtype).eps * torch.sqrt(
        _reduce(torch.sum(y_local * y_local), y))
    y_nu = _like(y, y_local + nu * _row_block(y, omega))
    g = _mm(omega.T, y_nu, "highest")                    # l x l
    c = cholesky(0.5 * (g + g.T))                        # lower
    # B = Y_nu C^{-T}:  A ~ B B^T - nu I on range(Y); row by row
    b = _like(y, torch.linalg.solve_triangular(c.T, _local(y_nu),
                                               upper=True, left=False))
    # B = U diag(s) W^T with s^2, W from the eigh of B^T B
    bg = _mm(b.T, b, "highest")
    s2, w = _eigh_descending(0.5 * (bg + bg.T))
    s2 = torch.clamp(s2, min=0.0)
    s = torch.sqrt(s2)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    u = _mm(b, w / safe[None, :], "highest")
    lam = torch.clamp(s2 - nu, min=0.0)
    return _to_api(_cols(u, slice(None, k))), lam[:k]


def nystrom_psd(a, k: int, p: int = 10, seed: int = 0,
                precision: str = "highest"):
    """Rank-k eigendecomposition A ~ U diag(lam) U^T of a symmetric PSD A
    from one pass over A.  Returns (U: n x k, lam: k) with lam >= 0
    descending.  A tensor stays on its device; any other array goes to
    the card; a DTensor whose rows are sharded is read block by block
    (the module docstring)."""
    a = _row_split(a)
    _check_square(a, "nystrom_psd")
    return _nystrom_impl(a, k=k, p=p, seed=seed, precision=precision)


def _reigh_impl(a, *, k, p, q, seed, precision):
    n = a.shape[0]
    l = min(k + p, n)
    omega = driver.generate_omega(seed, n, l, a.dtype, device=a.device)
    # for symmetric A each power round squares the spectrum's magnitude,
    # so the rSVD range finder applies unchanged
    q_mat = subspace_iteration(a, omega, q, precision=precision)
    # Rayleigh-Ritz: T = Q^T A Q, l x l
    t = _mm(q_mat.T, _mm(a, q_mat, precision), "highest")
    w, v = eigh(0.5 * (t + t.T))
    order = torch.argsort(-torch.abs(w), stable=True)   # by magnitude
    w, v = w[order], v[:, order]
    return w[:k], _mm(q_mat, v)[:, :k]


def reigh(a, k: int, p: int = 10, q: int = 2, seed: int = 0,
          precision: str = "highest"):
    """Randomized truncated eigendecomposition of a symmetric matrix:
    A ~ U diag(w) U^T with the k eigenpairs of largest magnitude, w
    signed (A may be indefinite).  Returns (w: k, U: n x k)."""
    a = as_tensor(a)
    _check_square(a, "reigh")
    return _reigh_impl(a, k=k, p=p, q=q, seed=seed, precision=precision)


def nystrom_reconstruct(u, lam):
    """A_k = U diag(lam) U^T."""
    return _mm(u * lam[None, :], u.T)


def nystrom_preconditioner(u, lam, mu):
    """Closure applying the Nystrom preconditioner P^{-1} (Frangella-
    Tropp-Udell 2023, eq. 5.1): with A ~ U diag(lam) U^T and mu > 0,

        P^{-1} r = U [ (lam_l + mu) / (lam + mu) - 1 ] (U^T r) + r,

    one skinny GEMM pair a call."""
    lam_last = lam[-1]

    def precond(r):
        coeff = (lam_last + mu) / (lam + mu) - 1.0
        return _mm(u, coeff[:, None] * _mm(u.T, r, "highest"),
                   "highest") + r

    return precond


def nystrom_pcg(a, b, mu: float, rank: int = 50, iters: int = 30,
                seed: int = 0, precision: str = "highest"):
    """Solve the regularized PSD system (A + mu I) x = b by ``iters``
    steps of CG with the randomized Nystrom preconditioner of rank
    ``rank`` (Frangella, Tropp & Udell 2023, Alg. 3).  Each step is one
    GEMM against A and one skinny GEMM pair.  ``b``: (n,) or (n, nrhs).
    A tensor stays on its device; any other array goes to the card."""
    a = as_tensor(a)
    _check_square(a, "nystrom_pcg")
    if mu <= 0:
        raise ValueError(f"mu must be > 0, got {mu}")
    b = as_tensor(b, device=a.device, dtype=a.dtype)
    rank = int(min(rank, a.shape[0]))
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    # the full sketch rank goes into the preconditioner (p = 0)
    u, lam = _nystrom_impl(a, k=rank, p=0, seed=seed, precision=precision)

    def apply_op(x):
        return _mm(a, x, precision) + mu * x

    x = _pcg_scan(apply_op, nystrom_preconditioner(u, lam, mu), b, iters)
    return x[:, 0] if squeeze else x


def reigh_generalized(a, b, k: int, p: int = 10, q: int = 2, seed: int = 0,
                      precision: str = "highest"):
    """Randomized truncated generalized symmetric eigendecomposition
    A v = lam B v, A symmetric and B symmetric positive definite.
    Returns (w: k, V: n x k) with V^T B V = I and w the k eigenvalues of
    largest magnitude.  Through B = L L^T: C = L^{-1} A L^{-T} has the
    same eigenvalues, and v = L^{-T} u."""
    a = as_tensor(a)
    b = as_tensor(b, device=a.device, dtype=a.dtype)
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"need square A, B of equal shape, got "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    l_chol = cholesky(0.5 * (b + b.T))

    def solve(x):                                   # L^{-1} x
        return torch.linalg.solve_triangular(l_chol, x, upper=False)

    c = solve(0.5 * (a + a.T))                      # L^{-1} A
    c = solve(c.T).T                                # L^{-1} A L^{-T}
    w, u = _reigh_impl(c, k=k, p=p, q=q, seed=seed, precision=precision)
    v = torch.linalg.solve_triangular(l_chol.T, u, upper=True)
    return w, v
