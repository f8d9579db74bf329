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

``nystrom_psd``, ``reigh`` and ``nystrom_pcg`` take a DTensor whose rows
are sharded: Y = A Omega, B and every n-sized panel stay row-split, the
l x l products are the driver's split products, all-reduced, and Omega
is drawn whole, as on one card; U comes back row-sharded.  ``reigh``'s
Rayleigh-Ritz product A Q gathers the l-wide Q, as XLA's partitioner
does.  ``nystrom_pcg`` takes b whole on every rank: the CG iterates are
row-split, their inner products all-reduced, each step gathers the
search direction (n x nrhs) for A p, and x comes back whole.
"""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    eigh,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    orthonormal_basis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _cholesky,
    _cols,
    _like,
    _local,
    _reduce,
    _row_block,
    _row_split,
    _sharded_view,
    _solve_lower,
    _solve_upper_t,
    _to_api,
    _transpose,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
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
    return _cols(u, slice(None, k)), lam[:k]


def nystrom_psd(a, k: int, p: int = 10, seed: int = 0,
                precision: str = "highest"):
    """Rank-k eigendecomposition A ~ U diag(lam) U^T of a symmetric PSD A
    from one pass over A.  Returns (U: n x k, lam: k) with lam >= 0
    descending.  A tensor stays on its device; any other array goes to
    the card; a DTensor whose rows are sharded is read block by block
    (the module docstring)."""
    a = _row_split(a)
    _check_square(a, "nystrom_psd")
    u, lam = _nystrom_impl(a, k=k, p=p, seed=seed, precision=precision)
    return _to_api(u), lam


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
    return w[:k], _cols(_mm(q_mat, v), slice(None, k))


def reigh(a, k: int, p: int = 10, q: int = 2, seed: int = 0,
          precision: str = "highest"):
    """Randomized truncated eigendecomposition of a symmetric matrix:
    A ~ U diag(w) U^T with the k eigenpairs of largest magnitude, w
    signed (A may be indefinite).  Returns (w: k, U: n x k).  A DTensor
    whose rows are sharded is read block by block (the module
    docstring); U then comes back row-sharded."""
    a = _row_split(a)
    _check_square(a, "reigh")
    w, u = _reigh_impl(a, k=k, p=p, q=q, seed=seed, precision=precision)
    return w, _to_api(u)


def nystrom_reconstruct(u, lam):
    """A_k = U diag(lam) U^T."""
    return _mm(u * lam[None, :], u.T)


def nystrom_preconditioner(u, lam, mu):
    """Closure applying the Nystrom preconditioner P^{-1} (Frangella-
    Tropp-Udell 2023, eq. 5.1): with A ~ U diag(lam) U^T and mu > 0,

        P^{-1} r = U [ (lam_l + mu) / (lam + mu) - 1 ] (U^T r) + r,

    one skinny GEMM pair a call.  With U row-sharded the closure takes
    and returns this rank's rows of r (U^T r all-reduced)."""
    u = _sharded_view(u)
    lam_last = lam[-1]

    def precond(r):
        coeff = (lam_last + mu) / (lam + mu) - 1.0
        return _local(_mm(u, coeff[:, None] * _mm(u.T, _like(u, r),
                                                   "highest"),
                          "highest")) + r

    return precond


def nystrom_pcg(a, b, mu: float, rank: int = 50, iters: int = 30,
                seed: int = 0, precision: str = "highest"):
    """Solve the regularized PSD system (A + mu I) x = b by ``iters``
    steps of CG with the randomized Nystrom preconditioner of rank
    ``rank`` (Frangella, Tropp & Udell 2023, Alg. 3).  Each step is one
    GEMM against A and one skinny GEMM pair.  ``b``: (n,) or (n, nrhs).
    A tensor stays on its device; any other array goes to the card; a
    DTensor whose rows are sharded takes b whole on every rank and
    returns x whole (the module docstring)."""
    a = _row_split(a)
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

    def apply_op(x):                                # x: this rank's rows
        return _local(_mm(a, _whole(_like(a, x)), precision)) + mu * x

    x = _pcg_scan(apply_op, nystrom_preconditioner(u, lam, mu),
                  _row_block(a, b), iters, rows=a)
    x = _whole(_like(a, x))
    return x[:, 0] if squeeze else x


def reigh_generalized(a, b, k: int, p: int = 10, q: int = 2, seed: int = 0,
                      precision: str = "highest"):
    """Randomized truncated generalized symmetric eigendecomposition
    A v = lam B v, A symmetric and B symmetric positive definite.
    Returns (w: k, V: n x k) with V^T B V = I and w the k eigenvalues of
    largest magnitude.  Through B = L L^T: C = L^{-1} A L^{-T} has the
    same eigenvalues, and v = L^{-T} u.  C is applied, never formed: the
    range finder and the Rayleigh-Ritz product run on
    x -> L^{-1} (A (L^{-T} x)), two triangular solves of an l-wide panel
    and one product with A a pass.

    A and B may be DTensors whose rows are sharded over one mesh (a
    whole B beside a sharded A is read by A's rows): L comes from the
    block Cholesky over the ranks (``rsvd/_sharded.py::_cholesky``), the
    solves are block substitutions, A's product gathers the l-wide
    panel, the symmetrizations read A^T and B^T through one all-to-all
    each, and V comes back row-sharded."""
    a = _row_split(a)
    if isinstance(a, Sharded):
        b = _row_split(b)
        if not isinstance(b, Sharded):
            b = a.with_local(_row_block(a, b.to(a.device, a.dtype)))
    else:
        b = as_tensor(b, device=a.device, dtype=a.dtype)
    if tuple(a.shape) != tuple(b.shape) or len(a.shape) != 2 \
            or a.shape[0] != a.shape[1]:
        raise ValueError(f"need square A, B of equal shape, got "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    l_chol = _cholesky(_like(b, 0.5 * (_local(b)
                                       + _local(_transpose(b)))))
    a_sym = _like(a, 0.5 * (_local(a) + _local(_transpose(a))))

    def apply_c(x):                                 # this rank's rows
        # L^{-T} x, row-major as the gathered panel is (the triangular
        # solve may return it column-major, and A's product then rounds
        # differently)
        y = _solve_upper_t(l_chol, x).contiguous()
        y = _local(_mm(a_sym, _whole(_like(a, y)), precision))
        return _solve_lower(l_chol, y)              # L^{-1} A L^{-T} x

    def basis(y):
        return _local(orthonormal_basis(_like(a, y), "robust"))

    n = a.shape[0]
    l = min(k + p, n)
    omega = driver.generate_omega(seed, n, l, a.dtype, device=a.device)
    # the driver's subspace iteration ('robust' QR, full
    # re-orthonormalization) on C, which is symmetric
    q_mat = basis(apply_c(_row_block(a, omega)))
    for _ in range(q):
        q_mat = basis(apply_c(basis(apply_c(q_mat))))
    t = _mm(_like(a, q_mat).T, _like(a, apply_c(q_mat)), "highest")
    w, v = eigh(0.5 * (t + t.T))
    order = torch.argsort(-torch.abs(w), stable=True)   # by magnitude
    w, v = w[order][:k], v[:, order][:, :k]
    u = _local(_mm(_like(a, q_mat), v))
    return w, _to_api(_like(a, _solve_upper_t(l_chol, u)))
