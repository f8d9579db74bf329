"""Block-Krylov randomized SVD (the JAX package's ``rsvd/krylov.py``;
Musco & Musco 2015).

Power iteration keeps only (A A^T)^q A Omega; the block-Krylov range
finder keeps every intermediate,

    K = [ Y_0, Y_1, ..., Y_q ],   Y_0 = A Omega,  Y_i = A A^T Y_{i-1},

and projects onto orth(K): the same passes over A, a better low-rank
approximation per pass on slowly decaying spectra.  Each block is
deflated against the accumulated basis (two passes of block classical
Gram-Schmidt) and orthonormalized on arrival, so the concatenation needs
no final QR; the tail factors the l(q+1) x n projection.

``qr_method`` and ``method`` pass through to ``linalg.qr.qr_reduced``
and ``linalg.svd.svd``: 'cholqr1_fused' runs each block's
orthonormalization as kernel K1, 'polar_fused' as K2 (q + 1 launches a
call), and 'eigh_pallas' the tail's l(q+1) x l(q+1) eigh as K3 (one
launch).  Omega comes from the driver's ``generate_omega`` on A's
device.

A DTensor whose rows are sharded is read block by block, as the
driver's ``rsvd`` reads it: Omega is drawn whole, the Krylov blocks stay
row-split (a block's QR factors the row-split panel, or gathers the
l-wide panel for K1, K2 and Householder), the projection and the
Gram-Schmidt coefficients are all-reduced, the tail is replicated (K3
on the replicated l(q+1) x l(q+1) Gram for 'eigh_pallas') and U comes
back row-sharded.
"""

from __future__ import annotations

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    orthonormal_basis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd as small_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _cat_cols,
    _cols,
    _like,
    _local,
    _row_split,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm


def krylov_basis(a, omega, q: int, qr_method: str = "robust",
                 precision=None):
    """Orthonormal basis of the block-Krylov space
    span[A Omega, (A A^T) A Omega, ..., (A A^T)^q A Omega]  (m x l(q+1)).

    Each block is deflated against the accumulated basis and
    orthonormalized before the next multiplication: block classical
    Gram-Schmidt with reorthogonalization, so the final concatenation
    needs no extra QR.  A DTensor whose rows are sharded (Omega whole on
    every rank) gives the basis row-sharded."""
    return _to_api(_krylov_basis(_row_split(a), omega, q, qr_method,
                                 precision))


def _krylov_basis(a, omega, q: int, qr_method: str, precision):
    def mm(x, y):
        return _mm(x, y, precision) if precision is not None else _mm(x, y)

    y = mm(a, omega)
    q_blk = orthonormal_basis(y, qr_method)
    blocks = [q_blk]

    for _ in range(q):
        y = mm(a, mm(a.T, q_blk))
        # two-pass block Gram-Schmidt against everything so far
        for _pass in range(2):
            for prev in blocks:
                y = _like(y, _local(y) - _local(mm(prev, mm(prev.T, y))))
        q_blk = orthonormal_basis(y, qr_method)
        blocks.append(q_blk)
    return _cat_cols(blocks)


def rsvd_krylov(
    a,
    k: int = 0,
    p: int = 10,
    q: int = 2,
    method="eigh",
    qr_method: str = "robust",
    seed: int = 0,
    precision: str = "highest",
):
    """Randomized truncated SVD with a block-Krylov range finder.

    The contract of ``rsvd`` (returns U[:, :k], s[:k], V[:, :k]), the
    same passes over A as ``rsvd`` at equal q, and a better
    approximation on slowly decaying spectra; the projected problem is
    l(q+1) x n instead of l x n.  A tensor stays on its device; any
    other array goes to the card; a DTensor whose rows are sharded is
    read block by block (the module docstring)."""
    a = _row_split(a)
    method = SVDMethod.parse(method)
    m, n = a.shape
    l = min(k + p if k > 0 else p, min(m, n))
    omega = driver.generate_omega(seed, n, l, a.dtype, device=a.device)
    q_mat = _krylov_basis(a, omega, q, qr_method, precision)  # m x l(q+1)
    b = _mm(q_mat.T, a, precision)                           # l(q+1) x n
    u_t, s, v = small_svd(b, method)
    u = _mm(q_mat, u_t)
    kk = k if k > 0 else l
    return _to_api(_cols(u, slice(None, kk))), s[:kk], v[:, :kk]
