"""Sketch-and-precondition least squares (Blendenpik-style; the JAX
package's ``rsvd/lstsq.py``).

min_x ||A x - b||_2 for tall A (m >> n): sketch A down to s x n
(s ~ 4n), QR the sketch, and use its R factor as a right preconditioner
for LSQR.  A R^{-1} has condition number O(1) with high probability
(Rokhlin-Tygert 2008; Avron-Maymounkov-Toledo 2010), so a FIXED number
of iterations reaches working-precision residuals whatever cond(A).
The dual, ``sketch_minnorm``, runs PCG on A A^T y = b preconditioned by
R^T R from a sketched QR of A^T.

The sketch is one GEMM (Gaussian or Rademacher S from ``sketch_matrix``)
or, with ``kind='sparse'``, the OSNAP embedding of
``ops/sketching.py``.  The QR is the CholeskyQR stack (``'robust'``: one
host sync for its fallback flag).  LSQR and PCG are Python loops of a
fixed length over device tensors: no host sync and no Python branch on
a tensor inside them, and the guards of the JAX scans
(``jnp.maximum(., eps)``) stay ``torch.clamp`` on the device.

Every solver takes a DTensor whose rows are sharded, with b whole on
every rank (each rank reads b's rows of its block): the sketch is drawn
whole, as on one card, and S A is the local rows' product all-reduced
(the sparse embedding draws its buckets and signs for every row and
applies its columns to the local rows); the augmented rows
sqrt(damp) I of the ridge problem join the last rank's block, so they
are counted once.  LSQR and PCG keep their m-sized vectors row-split and
all-reduce their inner products and A^T u; ``sketch_minnorm`` gathers
the sketch of A^T (s x m) and, a step, the PCG residual (m x nrhs) for
its preconditioner.  The solutions come back whole on every rank.  The
sparse sketch's sums use atomics on the card, so they are not bitwise
from run to run.
"""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION as _HI,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.sketching import (
    countsketch_rows,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _reduce,
    _row_block,
    _row_split,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm

_EPS = 1e-30


def _col_norm(v, rows=None):
    """Column norms of v; of an m-row v split as the operand ``rows`` is,
    its local sums all-reduced."""
    return torch.sqrt(_reduce(torch.sum(v * v, dim=0, keepdim=True), rows))


def _lsqr_scan(a, b, r_upper, iters: int):
    """LSQR (Paige-Saunders 1982) on the right-preconditioned operator
    A R^{-1}, ``iters`` bidiagonalization steps; b is (m, nrhs) and every
    state carries the rhs axis.  For a row-split A, b and the m-sized
    vectors u are this rank's rows: a step all-reduces A^T u (n x nrhs)
    and the norms of u."""
    def solve_r(y):                                 # R^{-1} y
        return torch.linalg.solve_triangular(r_upper, y, upper=True)

    def solve_rt(y):                                # R^{-T} y
        return torch.linalg.solve_triangular(r_upper.T, y, upper=False)

    def ap(x):                                      # A R^{-1} x
        return _local(_mm(a, solve_r(x), _HI))

    def apt(y):                                     # R^{-T} A^T y
        return solve_rt(_mm(a.T, _like(a, y), _HI))

    beta = _col_norm(b, a)
    u = b / torch.clamp(beta, min=_EPS)
    v0 = apt(u)
    alpha = _col_norm(v0)
    v = v0 / torch.clamp(alpha, min=_EPS)
    w = v
    x = torch.zeros_like(v)
    rho_bar, phi_bar = alpha, beta
    for _ in range(iters):
        u_next = ap(v) - alpha * u
        beta = _col_norm(u_next, a)
        u = u_next / torch.clamp(beta, min=_EPS)
        v_next = apt(u) - beta * v
        alpha = _col_norm(v_next)
        v = v_next / torch.clamp(alpha, min=_EPS)
        rho = torch.sqrt(rho_bar * rho_bar + beta * beta)
        c, s = rho_bar / rho, beta / rho
        theta = s * alpha
        rho_bar = -c * alpha
        phi = c * phi_bar
        phi_bar = s * phi_bar
        x = x + (phi / rho) * w
        w = v - (theta / rho) * w
    return solve_r(x)                               # back to original vars


def _left_sketch(a, seed, sketch_size: int, kind: str):
    """S A: the OSNAP embedding for ``kind='sparse'``, else a dense
    ``kind`` S (sketch_size x m) times A.  For a row-split A each rank
    applies S's columns of its rows and the sums are all-reduced; for
    the transpose of one (``sketch_minnorm``'s A^T) each rank sketches
    its columns and the s-row sketch is gathered."""
    key = key_from_seed(seed, a.device)
    if kind != "sparse":
        s_mat = sketch_matrix(key, sketch_size, a.shape[0], a.dtype, kind)
        out = _mm(s_mat, a, _HI)
    elif not isinstance(a, Sharded):
        return countsketch_rows(key, a, sketch_size)
    elif a.transposed:
        out = a.T.with_local(countsketch_rows(key, a.local.T,
                                              sketch_size).T).T
    else:
        return collectives.all_reduce(countsketch_rows(
            key, a.local, sketch_size, start=a.row_start,
            total=a.shape[0]), a.rows.group)
    if isinstance(out, Sharded):
        out = _whole(out.T).T.contiguous()
    return out


def _damped(a, damp: float):
    """[A; sqrt(damp) I]: for a row-split A, the n augmented rows join the
    last rank's block."""
    n = a.shape[1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    root = torch.sqrt(torch.tensor(damp, dtype=a.dtype))
    if not isinstance(a, Sharded):
        return torch.cat([a, root.to(a.device) * eye], dim=0)
    local = a.local
    if a.rows.index == a.rows.size - 1:
        local = torch.cat([local, root.to(a.device) * eye], dim=0)
    return Sharded(local, (a.shape[0] + n, n), a.mesh, a.rows,
                   start=a.row_start)


def sketch_lstsq(
    a,
    b,
    sketch_size: int | None = None,
    iters: int = 40,
    seed: int = 0,
    kind: str = "gaussian",
    damp: float = 0.0,
):
    """Solve min_x ||A x - b||_2 for tall A via sketched preconditioning.

    ``b``: (m,) or (m, nrhs); every right-hand side shares one
    preconditioner and one loop.  ``sketch_size`` defaults to 4n
    (clamped to m); ``iters=40`` LSQR steps reach about working precision
    on the O(1)-conditioned preconditioned operator.  ``kind='sparse'``
    sketches with the OSNAP embedding (ops/sketching.py): O(t m n)
    instead of the 4 m n^2 GEMM.  ``damp > 0`` solves the ridge problem
    min ||A x - b||^2 + damp ||x||^2 through the augmentation
    [A; sqrt(damp) I].  A tensor stays on its device; any other array
    goes to the card.

    A may be a DTensor whose rows are sharded, with b whole on every
    rank: each rank takes b's rows of its block, the sketch S A is the
    local rows' product all-reduced (S drawn whole, as on one card), and
    each LSQR step all-reduces A^T u and the norms of u.  The augmented
    rows of ``damp`` join the last rank's block (the module docstring).
    x comes back whole on every rank."""
    a = _row_split(a)
    b = as_tensor(b, device=a.device, dtype=a.dtype)
    m, n = a.shape
    if m < n:
        raise ValueError(f"need tall A (m >= n), got {tuple(a.shape)}")
    if damp < 0:
        raise ValueError(f"damp must be >= 0, got {damp}")
    if damp > 0:
        a = _damped(a, damp)
        b = torch.cat([b, b.new_zeros((n,) + tuple(b.shape[1:]))], dim=0)
        m = m + n
    s = int(min(m, sketch_size if sketch_size is not None else 4 * n))
    if s < n:
        raise ValueError(f"sketch_size {s} < n {n} cannot precondition")
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    _, r_upper = qr_reduced(_left_sketch(a, seed, s, kind), "robust")
    x = _lsqr_scan(a, _row_block(a, b), r_upper, iters)
    return x[:, 0] if squeeze else x


def _pcg_scan(apply_op, precond, b, iters: int, rows=None):
    """Fixed-iteration preconditioned conjugate gradients on an SPD
    operator; b is (m, nrhs) and every state carries the rhs axis.  With
    ``rows`` a row-split operand, b and every iterate are this rank's
    rows of the m-sized vectors, and their inner products are
    all-reduced over the rows."""
    def dot(x, y):
        return _reduce(torch.sum(x * y, dim=0, keepdim=True), rows)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        op = apply_op(p)
        alpha = rz / torch.clamp(dot(p, op), min=_EPS)
        x = x + alpha * p
        r = r - alpha * op
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=_EPS)
        p = z + beta * p
        rz = rz_new
    return x


def sketch_minnorm(
    a,
    b,
    sketch_size: int | None = None,
    iters: int = 40,
    seed: int = 0,
    kind: str = "gaussian",
):
    """Minimum-norm solution of the underdetermined A x = b (m < n, full
    row rank): x* = A^T (A A^T)^{-1} b, the dual of
    :func:`sketch_lstsq`, without forming A A^T.

    PCG on (A A^T) y = b (two GEMVs against A an iteration),
    preconditioned by R^T R from a sketched QR of the tall A^T; then
    x* = A^T y lies in range(A^T), which is the minimum-norm property.
    A tensor stays on its device; any other array goes to the card; a
    DTensor whose rows are sharded takes b whole on every rank and
    returns x whole (the module docstring)."""
    a = _row_split(a)
    b = as_tensor(b, device=a.device, dtype=a.dtype)
    m, n = a.shape
    if m > n:
        raise ValueError(f"need wide A (m <= n) for min-norm, got "
                         f"{tuple(a.shape)}; use sketch_lstsq for tall "
                         "systems")
    s = int(min(n, sketch_size if sketch_size is not None else 4 * m))
    if s < m:
        raise ValueError(f"sketch_size {s} < m {m} cannot precondition")
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    # sketch the TALL A^T (n x m): R = qr(S A^T) is m x m with
    # R^T R ~ A A^T
    _, r_upper = qr_reduced(_left_sketch(a.T, seed, s, kind), "robust")

    def apply_aat(y):                               # (A A^T) y, two GEMMs
        return _local(_mm(a, _mm(a.T, _like(a, y), _HI), _HI))

    def precond(r):                                 # (R^T R)^{-1} r
        r = torch.linalg.solve_triangular(r_upper.T, _whole(_like(a, r)),
                                          upper=False)
        return _row_block(a, torch.linalg.solve_triangular(r_upper, r,
                                                           upper=True))

    y = _pcg_scan(apply_aat, precond, _row_block(a, b), iters, rows=a)
    x = _mm(a.T, _like(a, y), _HI)
    return x[:, 0] if squeeze else x


def lstsq_residual(a, x, b):
    """||A x - b||_2 per right-hand side (diagnostic); a scalar for a
    1-D x.  A row-sharded A takes x and b whole on every rank."""
    a = _row_split(a)
    x = as_tensor(x, device=a.device, dtype=a.dtype)
    b = as_tensor(b, device=a.device, dtype=a.dtype)
    squeeze = x.dim() == 1
    if squeeze:
        x, b = x[:, None], b.reshape(-1, 1)
    r = _local(_mm(a, x, _HI)) - _row_block(a, b)
    out = torch.sqrt(_reduce(torch.sum(r * r, dim=0), a))
    return out[0] if squeeze else out
