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

A DTensor whose rows are sharded over P ranks (2^levels a multiple of P,
so each leaf falls to one rank) is built without gathering it:

- at a level whose blocks lie inside one rank (2^(ell+1) >= P) each rank
  factors its own blocks with the batched rSVD, no collective; where a
  rank holds whole sibling pairs (2^ell >= P) the level's stacks are
  DTensors sharded on the block index;
- at a level above (2^(ell+1) < P) a block's rows span P / 2^(ell+1)
  ranks, and it is factored as a row-split rSVD over the process group
  of those ranks (one group a block, made once and kept);
- a level with fewer pairs than ranks keeps its stacks replicated: one
  all-gather each of the U and V rows (n x k), no block of A;
- the leaves are a DTensor sharded on the leaf index.

``hodlr_matvec`` keeps x and y row-split: the local levels and the
leaves are local batched products, and each replicated level's V^T x is
one all-reduce of its (2^ell, 2, k, c) coefficients.  ``hodlr_solve``'s
CG all-reduces its dot products, its preconditioner is the local
leaves' Cholesky, and x comes back row-sharded.  On one rank every level
is local, so a one-rank group is the single call to the bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

import torch.distributed as dist

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    ieee_fp32,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Axis,
    Sharded,
    from_dtensor,
    is_dtensor,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _row_block,
    _row_split,
    _sharded_view,
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
    device; any other array goes to the card; a DTensor whose rows are
    sharded is built by its rows (the module docstring)."""
    a = _row_split(a)
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("HODLR requires a square matrix")
    _check_levels(n, levels)
    if isinstance(a, Sharded):
        def block(i0, j0, rows, cols):
            start = i0 - a.row_start
            return a.local[start:start + rows, j0:j0 + cols]

        return _build_split(block, a, n, levels, k, p, q, seed)
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


def _split_of(h: HodlrMatrix):
    """The row split of a sharded HODLR matrix's n rows (a
    :class:`Sharded` holding nothing but the layout), or None."""
    if not is_dtensor(h.leaves):
        return None
    view = from_dtensor(h.leaves)
    rows = h.n // view.rows.size
    return Sharded(view.local.new_zeros((rows, 0)), (h.n, 0), view.mesh,
                   view.rows)


def hodlr_matvec(h: HodlrMatrix, x) -> torch.Tensor:
    """y = H x in O(k n log n): per level, batched (b, m, k) products.
    ``x`` is a vector (n,) or a block of columns (n, c).  For a sharded
    H (the module docstring) x is row-sharded alike, or whole (each rank
    takes its rows), and y comes back row-sharded."""
    split = _split_of(h)
    if split is None:
        x = as_tensor(x, device=h.leaves.device)
        xm = x[:, None] if x.dim() == 1 else x
        y = _matvec_local(h, xm, None)
        return y[:, 0] if x.dim() == 1 else y
    x = _sharded_view(x)
    if not isinstance(x, Sharded):
        x = as_tensor(x, device=split.device)
    xm = _row_block(split, x)
    vector = xm.dim() == 1
    y = _matvec_local(h, xm[:, None] if vector else xm, split)
    return row_dtensor(y[:, 0] if vector else y, split.mesh, split.rows,
                       h.n)


def _matvec_local(h: HodlrMatrix, xm, split):
    """H x on x's (n, c) block, or, with ``split`` a row split, on this
    rank's rows of it, giving this rank's rows of H x."""
    c = xm.shape[1]
    with ieee_fp32():
        y = torch.zeros_like(xm)
        for fu, fv, gu, gv in zip(h.u_upper, h.v_upper, h.u_lower,
                                  h.v_lower):
            if split is not None and not is_dtensor(fu):
                y = y + _replicated_level(fu, fv, gu, gv, xm, split)
                continue
            fu, fv, gu, gv = (f.to_local() if is_dtensor(f) else f
                              for f in (fu, fv, gu, gv))
            b, m, _ = fu.shape
            xb = xm.reshape(b, 2 * m, c)
            x1, x2 = xb[:, :m], xb[:, m:]
            y1 = torch.bmm(fu, torch.bmm(fv.transpose(1, 2), x2))
            y2 = torch.bmm(gu, torch.bmm(gv.transpose(1, 2), x1))
            y = y + torch.cat([y1, y2], dim=1).reshape(-1, c)
        leaves = h.leaves.to_local() if split is not None else h.leaves
        leaf = leaves.shape[1]
        yl = torch.bmm(leaves, xm.reshape(-1, leaf, c)).reshape(-1, c)
    return y + yl


def _replicated_level(fu, fv, gu, gv, xm, split):
    """A level whose (b, m, k) stacks every rank holds whole, on this
    rank's rows of x: this rank's rows lie in one half-block (m a
    multiple of the rank's rows), its partial V^T x goes into its pair's
    slot, one all-reduce completes them, and its rows of y take the
    sibling's coefficients."""
    b, m, k = fu.shape
    rows, c = xm.shape
    half, off = divmod(split.row_start, m)
    pair, upper = divmod(half, 2)
    upper = upper == 0
    mine = slice(off, off + rows)
    coeff = xm.new_zeros((b, 2, k, c))
    # slot 0: fv^T x2 (read by the upper rows), slot 1: gv^T x1
    coeff[pair, 1 if upper else 0] = torch.mm(
        (gv if upper else fv)[pair, mine].T, xm)
    coeff = collectives.all_reduce(coeff, split.rows.group)
    return torch.mm((fu if upper else gu)[pair, mine],
                    coeff[pair, 0 if upper else 1])


_BLOCK_GROUPS = {}


def _block_group(split, span: int):
    """This rank's process group among the ``span`` consecutive ranks of
    the row group that hold one block's rows, as an :class:`Axis`; made
    once for those ranks of that row group (only they call it) and
    kept."""
    ranks = dist.get_process_group_ranks(split.rows.group)
    first = split.rows.index // span * span
    key = (split.rows.group, tuple(ranks[first:first + span]))
    if key not in _BLOCK_GROUPS:
        _BLOCK_GROUPS[key] = dist.new_group(
            list(key[1]), use_local_synchronization=True)
    return Axis(_BLOCK_GROUPS[key], split.rows.index - first, span,
                split.rows.dims)


def _build_split(block, split, n: int, levels: int, k: int, p: int, q: int,
                 seed: int) -> HodlrMatrix:
    """HODLR form of the row-split n x n matrix whose blocks in this
    rank's rows ``block(i0, j0, rows, cols)`` returns (the module
    docstring)."""
    size, start = split.rows.size, split.row_start
    rows = n // size
    if (2 ** levels) % size:
        raise ValueError(f"a row-sharded HODLR build needs 2^levels = "
                         f"{2 ** levels} to be a multiple of the {size} "
                         "ranks: each leaf falls to one rank")
    probe = block(start, 0, 1, 1)
    u_up, v_up, u_lo, v_lo = [], [], [], []
    for ell in range(levels):
        b = 2 ** ell
        m = n // (2 * b)
        kk = min(k, m)
        omega = generate_omega(seed + ell, m, min(kk + p, m), probe.dtype,
                               device=probe.device)
        if b >= size:                   # whole sibling pairs on this rank
            pairs = range(start // (2 * m), (start + rows) // (2 * m))
            fu, fv = _factor_stack(torch.stack([
                block(i * 2 * m, i * 2 * m + m, m, m) for i in pairs]),
                omega, q, kk)
            gu, gv = _factor_stack(torch.stack([
                block(i * 2 * m + m, i * 2 * m, m, m) for i in pairs]),
                omega, q, kk)
            for out, f in ((u_up, fu), (v_up, fv), (u_lo, gu), (v_lo, gv)):
                out.append(row_dtensor(f, split.mesh, split.rows, b))
            continue
        half, off = divmod(start, m)    # this rank's half-block
        col0 = (half + 1) * m if half % 2 == 0 else (half - 1) * m
        mine = block(start, col0, rows, m)
        if m == rows:                   # the block is this rank's alone
            fu, fv = _factor_stack(mine[None], omega, q, kk)
            fu, fv = fu[0], fv[0]
        else:                           # a row-split rSVD over its ranks
            view = Sharded(mine, (m, m), split.mesh,
                           _block_group(split, m // rows))
            u, sv, fv = rsvd_with_omega(view, omega, q=q, k=omega.shape[1],
                                        method="eigh", reorth="half")
            fu = (u.to_local() if is_dtensor(u) else u) * sv[None, :]
            fu, fv = fu[:, :kk], fv[:, :kk]
        # every rank's rows of U and its rows of V (the sibling's side)
        # gathered: the level's stacks, replicated
        us = split.with_local(fu.contiguous()).gather()
        vs = split.with_local(fv[off:off + rows].contiguous()).gather()
        us, vs = us.reshape(b, 2, m, kk), vs.reshape(b, 2, m, kk)
        u_up.append(us[:, 0])
        u_lo.append(us[:, 1])
        v_up.append(vs[:, 0])
        v_lo.append(vs[:, 1])
    leaf = n // 2 ** levels
    leaves = torch.stack([block(i, i, leaf, leaf)
                          for i in range(start, start + rows, leaf)])
    return HodlrMatrix(tuple(u_up), tuple(v_up), tuple(u_lo), tuple(v_lo),
                       row_dtensor(leaves, split.mesh, split.rows,
                                   2 ** levels), n=n, k=k)


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


def _cg(apply_a, precond, b, tol: float, maxiter: int, split=None):
    """Preconditioned CG on each column of b (n x c) with the arithmetic
    of ``jax.scipy.sparse.linalg.cg``: x0 = 0, z = M r, gamma = r.z,
    beta = gamma'/gamma, a column stops once ||r||^2 <= max(tol^2
    ||b||^2, 0) or after ``maxiter`` steps, and its iterates freeze.
    Returns (x, steps per column).  With ``split`` a row split, b and
    the iterates are this rank's rows and every dot product is
    all-reduced, so each rank takes the same steps."""
    def vdot(u, v):
        dot = torch.sum(u * v, dim=0)
        if split is None:
            return dot
        return collectives.all_reduce(dot, split.rows.group)

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
    ``return_steps`` also returns the CG steps each column took.  For a
    sharded H (the module docstring) b is row-sharded alike or whole,
    and x comes back row-sharded."""
    split = _split_of(h)
    if split is not None:
        b = _sharded_view(b)
        if not isinstance(b, Sharded):
            b = as_tensor(b, device=split.device)
        b = _row_block(split, b)
    else:
        b = as_tensor(b, device=h.leaves.device)
    x, steps = _solve_rows(h, b[:, None] if b.dim() == 1 else b, split,
                           tol, maxiter)
    x = x[:, 0] if b.dim() == 1 else x
    if split is not None:
        x = row_dtensor(x, split.mesh, split.rows, h.n)
    return (x, steps) if return_steps else x


def _solve_rows(h: HodlrMatrix, bm, split, tol: float, maxiter: int):
    """CG on the (n, c) block ``bm``, or, with ``split`` a row split, on
    this rank's rows of it: (x, steps per column)."""
    leaves = h.leaves.to_local() if split is not None else h.leaves
    chol = cholesky(leaves)
    leaf = leaves.shape[1]

    def precond(r):
        # two batched triangular solves (cuBLAS trsm); torch.cholesky_solve
        # on the card goes through MAGMA's batched trsv, which waits for
        # the host once a call
        z = torch.linalg.solve_triangular(
            chol, r.reshape(-1, leaf, r.shape[1]), upper=False)
        z = torch.linalg.solve_triangular(chol.transpose(1, 2), z,
                                          upper=True)
        return z.reshape(r.shape)

    return _cg(lambda v: _matvec_local(h, v, split), precond, bm, tol,
               maxiter, split)
