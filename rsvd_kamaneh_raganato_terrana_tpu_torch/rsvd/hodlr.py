"""HODLR hierarchical low-rank compression on the randomized engine (the
JAX package's ``rsvd/hodlr.py``).

A HODLR matrix (Hierarchically Off-Diagonal Low-Rank; Ambikasaran &
Darve 2013) stores an n x n matrix as a binary tree: dense diagonal leaf
blocks plus rank-k factorizations of every off-diagonal block at every
level -- O(k n log n) storage and matvec instead of O(n^2).

All blocks at one level share a shape, so each level's off-diagonal
factorizations run as ONE ``torch.func.vmap`` of ``rsvd_with_omega``
over the stacked blocks (one Omega a level, drawn from ``seed + ell``),
batched products on the card.  Under the transform the driver's 'robust'
QR computes the CholeskyQR2 and Householder branches and selects per
block, as ``jax.vmap`` does with its ``lax.cond``.  Factors live as
(blocks, m, k) stacks per level.

``hodlr_solve`` is preconditioned CG with the arithmetic of
``jax.scipy.sparse.linalg.cg``; a block of right-hand sides runs as one
batched CG whose columns each keep their own step sizes and freeze once
converged, as the JAX ``while_loop`` does under ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    ieee_fp32,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    generate_omega,
    rsvd_with_omega,
)

# CG reads its stopping flag on the host once per this many iterations;
# the iterates of converged columns are frozen in between
_CG_CHECK_EVERY = 4


class HodlrMatrix(NamedTuple):
    """Stacked-factor HODLR representation.

    For level ell (0 = coarsest split), block size m_ell = n / 2^(ell+1)
    and there are b_ell = 2^ell sibling pairs:
      u_upper[ell]: (b_ell, m_ell, k) -- row basis of each A12 block
      v_upper[ell]: (b_ell, m_ell, k) -- A12 ~ u s v^T folded: u @ v^T
      u_lower/v_lower: same for the A21 blocks
    leaves: (2^levels, leaf, leaf) dense diagonal blocks.
    """

    u_upper: Tuple[torch.Tensor, ...]
    v_upper: Tuple[torch.Tensor, ...]
    u_lower: Tuple[torch.Tensor, ...]
    v_lower: Tuple[torch.Tensor, ...]
    leaves: torch.Tensor
    n: int
    k: int


def _check_levels(n: int, levels: int) -> None:
    if n % (2 ** levels):
        raise ValueError(f"n={n} not divisible by 2^levels={2 ** levels}")


def _off_diagonal_blocks(a, level: int):
    """Stacked (A12, A21) blocks at a level: a is n x n, block size
    m = n / 2^(level+1)."""
    b = 2 ** level
    m = a.shape[0] // (2 * b)
    pairs = a.reshape(b, 2, m, b, 2, m)
    idx = torch.arange(b, device=a.device)
    return pairs[idx, 0, :, idx, 1, :], pairs[idx, 1, :, idx, 0, :]


def _leaf_blocks(a, levels: int):
    nb = 2 ** levels
    leaf = a.shape[0] // nb
    idx = torch.arange(nb, device=a.device)
    return a.reshape(nb, leaf, nb, leaf)[idx, :, idx, :]


def _factor_stack(blocks, omega, q: int, kk: int):
    """(u * s, v) of every block of the (b, m, m) stack, truncated to kk
    columns: one vmapped rSVD with the shared Omega."""
    def one(blk):
        u, s, v = rsvd_with_omega(blk, omega, q=q, k=omega.shape[1],
                                  method="eigh", reorth="half")
        return u * s[None, :], v

    fu, fv = torch.func.vmap(one)(blocks)
    return fu[..., :kk], fv[..., :kk]


def hodlr_build(a, levels: int = 3, k: int = 16, p: int = 10, q: int = 1,
                seed: int = 0) -> HodlrMatrix:
    """Compress a dense n x n matrix (n divisible by 2**levels) into
    HODLR form with rank-k off-diagonal blocks.  A tensor stays on its
    device; any other array goes to the card."""
    a = as_tensor(a)
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("HODLR requires a square matrix")
    _check_levels(n, levels)
    u_up, v_up, u_lo, v_lo = [], [], [], []
    for ell in range(levels):
        uppers, lowers = _off_diagonal_blocks(a, ell)
        m = uppers.shape[1]
        kk = min(k, m)
        omega = generate_omega(seed + ell, m, min(kk + p, m), a.dtype,
                               device=a.device)
        for stack, us, vs in ((uppers, u_up, v_up), (lowers, u_lo, v_lo)):
            fu, fv = _factor_stack(stack, omega, q, kk)
            us.append(fu)
            vs.append(fv)
    return HodlrMatrix(tuple(u_up), tuple(v_up), tuple(u_lo), tuple(v_lo),
                       _leaf_blocks(a, levels), n=n, k=k)


def hodlr_build_implicit(block_fn, n: int, levels: int = 3, k: int = 16,
                         p: int = 10, q: int = 1, seed: int = 0,
                         device=None) -> HodlrMatrix:
    """HODLR compression of an IMPLICIT matrix -- no dense n x n ever
    materializes, so this builds at sizes where the dense operand cannot
    exist on the card.

    ``block_fn(i0, j0, rows, cols)`` must return the dense block
    ``A[i0:i0+rows, j0:j0+cols]``: a tensor stays on its device, any
    other array goes to ``device`` (the card unless the caller names
    another).  Only ONE TRIANGLE of one level's stacked off-diagonal
    blocks (n^2/2^(ell+2) entries, a quarter of A at ell = 0) plus the
    leaf stack are ever resident: the upper stack is factorized and freed
    before the lower stack is formed."""
    _check_levels(n, levels)

    def block(i0, j0, rows, cols):
        return as_tensor(block_fn(i0, j0, rows, cols), device=device)

    u_up, v_up, u_lo, v_lo = [], [], [], []
    probe = None
    for ell in range(levels):
        b = 2 ** ell
        m = n // (2 * b)
        kk = min(k, m)
        if probe is None:
            # the sketch takes the blocks' dtype and device (an f64 run
            # must not get f32 sketches and lose dense/implicit parity)
            probe = block(0, m, 1, 1)
        omega = generate_omega(seed + ell, m, min(kk + p, m), probe.dtype,
                               device=probe.device)
        uppers = torch.stack([block(i * 2 * m, i * 2 * m + m, m, m)
                              for i in range(b)])
        fu, fv = _factor_stack(uppers, omega, q, kk)
        del uppers
        lowers = torch.stack([block(i * 2 * m + m, i * 2 * m, m, m)
                              for i in range(b)])
        gu, gv = _factor_stack(lowers, omega, q, kk)
        del lowers
        u_up.append(fu)
        v_up.append(fv)
        u_lo.append(gu)
        v_lo.append(gv)
    leaf = n // 2 ** levels
    leaves = torch.stack([block(i * leaf, i * leaf, leaf, leaf)
                          for i in range(2 ** levels)])
    return HodlrMatrix(tuple(u_up), tuple(v_up), tuple(u_lo), tuple(v_lo),
                       leaves, n=n, k=k)


def hodlr_matvec(h: HodlrMatrix, x) -> torch.Tensor:
    """y = H x in O(k n log n): per level, batched (b, m, k) products.
    ``x`` is a vector (n,) or a block of columns (n, c)."""
    x = as_tensor(x, device=h.leaves.device)
    xm = x[:, None] if x.dim() == 1 else x
    c = xm.shape[1]
    with ieee_fp32():
        y = torch.zeros_like(xm)
        for fu, fv, gu, gv in zip(h.u_upper, h.v_upper, h.u_lower,
                                  h.v_lower):
            b, m, _ = fu.shape
            xb = xm.reshape(b, 2 * m, c)
            x1, x2 = xb[:, :m], xb[:, m:]
            y1 = torch.bmm(fu, torch.bmm(fv.transpose(1, 2), x2))
            y2 = torch.bmm(gu, torch.bmm(gv.transpose(1, 2), x1))
            y = y + torch.cat([y1, y2], dim=1).reshape(-1, c)
        leaf = h.leaves.shape[1]
        yl = torch.bmm(h.leaves, xm.reshape(-1, leaf, c)).reshape(-1, c)
    y = y + yl
    return y[:, 0] if x.dim() == 1 else y


def hodlr_reconstruct(h: HodlrMatrix) -> torch.Tensor:
    """Dense n x n reconstruction (testing/inspection)."""
    n = h.n
    a = h.leaves.new_zeros((n, n))
    for fu, fv, gu, gv in zip(h.u_upper, h.v_upper, h.u_lower, h.v_lower):
        b, m, _ = fu.shape
        for i in range(b):
            r0 = i * 2 * m
            a[r0:r0 + m, r0 + m:r0 + 2 * m] = _mm(fu[i], fv[i].T)
            a[r0 + m:r0 + 2 * m, r0:r0 + m] = _mm(gu[i], gv[i].T)
    leaf = h.leaves.shape[1]
    for i in range(h.leaves.shape[0]):
        a[i * leaf:(i + 1) * leaf, i * leaf:(i + 1) * leaf] = h.leaves[i]
    return a


def hodlr_compression_ratio(h: HodlrMatrix) -> float:
    """dense entries / stored entries."""
    stored = h.leaves.numel()
    for fu in h.u_upper:
        stored += 4 * fu.numel()          # u/v upper + u/v lower, same size
    return (h.n * h.n) / stored


def _cg(apply_a, precond, b, tol: float, maxiter: int):
    """Preconditioned CG on each column of b (n x c) with the arithmetic
    of ``jax.scipy.sparse.linalg.cg``: x0 = 0, z = M r, gamma = r.z,
    beta = gamma'/gamma, a column stops once ||r||^2 <= max(tol^2
    ||b||^2, 0) or after ``maxiter`` steps, and its iterates freeze.
    Returns (x, steps per column)."""
    def vdot(u, v):
        return torch.sum(u * v, dim=0)

    atol2 = torch.clamp(tol * tol * vdot(b, b), min=0.0)
    x = torch.zeros_like(b)
    r = b - apply_a(x)
    p = precond(r)
    gamma = vdot(r, p)
    steps = torch.zeros(b.shape[1], dtype=torch.int64, device=b.device)
    for it in range(maxiter):
        running = vdot(r, r) > atol2
        if it % _CG_CHECK_EVERY == 0 and not bool(running.any()):
            break
        ap = apply_a(p)
        alpha = gamma / vdot(p, ap)
        x = torch.where(running, x + alpha * p, x)
        r_new = r - alpha * ap
        z = precond(r_new)
        gamma_new = vdot(r_new, z)
        p = torch.where(running, z + (gamma_new / gamma) * p, p)
        r = torch.where(running, r_new, r)
        gamma = torch.where(running, gamma_new, gamma)
        steps = steps + running.to(torch.int64)
    return x, steps


def hodlr_solve(h: HodlrMatrix, b, tol: float = 1e-8,
                maxiter: int = 200, return_steps: bool = False):
    """Solve H x = b for SPD H (kernel + ridge matrices, the HODLR use
    case) by conjugate gradients on the O(kn log n) matvec, with the
    dense leaf blocks as a block-Jacobi preconditioner (their Cholesky
    factors computed once, batched; a failed factor is NaN, so an
    indefinite operator gives a non-finite x).  ``b`` is a vector (n,) or
    a block of columns (n, c), each column solved on its own.  With
    ``return_steps`` also returns the CG steps each column took."""
    b = as_tensor(b, device=h.leaves.device)
    bm = b[:, None] if b.dim() == 1 else b
    chol = cholesky(h.leaves)
    leaf = h.leaves.shape[1]

    def precond(r):
        # two batched triangular solves (cuBLAS trsm); torch.cholesky_solve
        # on the card goes through MAGMA's batched trsv, which waits for
        # the host once a call
        z = torch.linalg.solve_triangular(
            chol, r.reshape(-1, leaf, r.shape[1]), upper=False)
        z = torch.linalg.solve_triangular(chol.transpose(1, 2), z,
                                          upper=True)
        return z.reshape(r.shape)

    x, steps = _cg(lambda v: hodlr_matvec(h, v), precond, bm, tol,
                   maxiter)
    x = x[:, 0] if b.dim() == 1 else x
    return (x, steps) if return_steps else x
