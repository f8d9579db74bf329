"""Randomized interpolative (ID) and CUR decompositions (the JAX
package's ``rsvd/interp.py``).

ID/CUR express A in terms of its own columns/rows:

    column ID:  A  ~  A[:, J] @ X          (J: k column indices)
    CUR:        A  ~  C @ U @ R            (C = A[:, J], R = A[I, :])

All O(mn) work is one sketch GEMM (G = Omega^T A, l x n); the greedy
column pivoting runs on the small sketch only, as a k-step loop of
rank-1 updates that stays on the device (no host sync).  The
interpolation matrix comes from the robust CholeskyQR of the pivot
block and one triangular solve.

Method: Halko-Martinsson-Tropp 2011 sec. 5.2 (randomized ID) with
sketch-space pivoting (Voronin & Martinsson 2017); CUR by row-ID x
column-ID composition with a least-squares core (Mahoney & Drineas 2009).
Omega comes from the driver's ``generate_omega`` on A's device (torch
Philox streams, not JAX's threefry values); indices are int64.

Every function takes a DTensor whose rows are sharded.  Omega is drawn
whole, as on one card, so pivots and indices do not depend on the split.
The column ID's sketch Omega^T A is the local rows' product all-reduced;
the row ID pivots over the rows of Y = A Omega, whose l-wide panel is
gathered, as XLA's partitioner gathers it; CUR's rows of A are taken
from the ranks that hold them (one all-reduce of the k x n block).
Factors with A's rows (the row ID's X, the reconstructions, the row
leverage scores) come back row-sharded, everything else replicated.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _argmax,
    _like,
    _local,
    _row_split,
    _sharded_view,
    _take_rows,
    _to_api,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm

# the JAX package's fold-in salt of leverage_sample's Gumbel stream
_GUMBEL_SALT = 0x1e7a


def _greedy_pivots(g, k: int, split=None):
    """k greedy column pivots of the small sketch G (l x n): at each step
    pick the column of largest residual norm (the first of equal ones, as
    ``argmax`` does in both packages), then deflate its direction (one
    rank-1 update): right-looking pivoted Gram-Schmidt.

    With ``split`` a row split whose rows are G's columns (G = U^T of a
    row-split U), ``g`` is this rank's columns: the argmax is global
    (``rsvd/_sharded.py::_argmax``), the pivot column and its norm come
    from the rank that holds them (``_take_rows``), and the indices are
    global, equal to the single call's."""
    n = g.shape[1]
    eps = torch.finfo(g.dtype).eps
    r = g
    idx = torch.zeros((k,), dtype=torch.int64, device=g.device)
    mask = torch.zeros((n,), dtype=torch.bool, device=g.device)
    start = split.row_start if isinstance(split, Sharded) else 0
    local = torch.arange(n, device=g.device)
    for i in range(k):
        norms = torch.sum(r * r, dim=0)
        norms = torch.where(mask, -torch.inf, norms)
        j = _argmax(norms, split).reshape(1)
        if isinstance(split, Sharded):
            picked = _take_rows(split.with_local(
                torch.cat([r.T, norms[:, None]], dim=1)), j)[0]
            col, norm_j = picked[:-1], picked[-1]
        else:
            col = r.index_select(1, j)[:, 0]
            norm_j = norms.index_select(0, j)[0]
        scale = torch.sqrt(torch.clamp(norm_j, min=eps * eps))
        q = col / scale
        r = r - torch.outer(q, _mm(q[None, :], r)[0])
        idx[i] = j[0]
        mask = mask | (local == j - start)
    return idx


def _column_id_impl(a, *, k, p, seed, precision):
    m, n = a.shape
    l = min(k + p, min(m, n))
    omega = driver.generate_omega(seed, m, l, a.dtype, device=a.device)
    g = _mm(omega.T, a, precision)                    # l x n sketch
    if isinstance(g, Sharded):
        # A^T of a row-split A: Omega^T A^T is split by its columns; the
        # pivoting reads every column of the l-wide panel
        g = _whole(g.T).T.contiguous()
    cols = _greedy_pivots(g, k)
    # interpolation: X = argmin ||G[:, J] X - G||_F, via thin QR of the
    # l x k pivot block (robust CholeskyQR2 with Householder fallback)
    gj = g.index_select(1, cols)
    q, r = qr_reduced(gj, "robust")
    x = torch.linalg.solve_triangular(r, _mm(q.T, g, "highest"), upper=True)
    return cols, x


def column_id(
    a,
    k: int,
    p: int = 10,
    seed: int = 0,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-k column interpolative decomposition: A ~ A[:, cols] @ X.

    Returns (cols: int64[k], X: k x n).  X[:, cols] is (numerically) the
    identity: selected columns represent themselves.
    """
    a = _row_split(a)
    return _column_id_impl(a, k=k, p=p, seed=seed, precision=precision)


def row_id(a, k: int, p: int = 10, seed: int = 0,
           precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-k row ID: A ~ X @ A[rows, :].  Returns (rows, X: m x k); X
    row-sharded where A is."""
    a = _row_split(a)
    rows, xt = _column_id_impl(a.T, k=k, p=p, seed=seed,
                               precision=precision)
    if isinstance(a, Sharded):
        return rows, _to_api(a.keep_rows(xt.T))
    return rows, xt.T


def cur(
    a,
    k: int,
    p: int = 10,
    seed: int = 0,
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-k CUR decomposition: A ~ A[:, cols] @ U @ A[rows, :].

    Returns (cols: int64[k], rows: int64[k], U: k x k).  Reconstruct with
    ``cur_reconstruct(a, cols, rows, u)``.
    """
    a = _row_split(a)
    cols, _ = _column_id_impl(a, k=k, p=p, seed=seed, precision=precision)
    rows, _ = _column_id_impl(a.T, k=k, p=p, seed=seed + 1,
                              precision=precision)
    c = _like(a, _local(a).index_select(1, cols))   # m x k
    r = _take_rows(a, rows)                         # k x n
    # core U = C^+ A R^+ via two least-squares solves (QR-based, no pinv):
    qc, rc = qr_reduced(c, "robust")
    t = torch.linalg.solve_triangular(              # C^+ A  (k x n)
        rc, _mm(qc.T, a, "highest"), upper=True)
    qr_, rr = qr_reduced(r.T, "robust")
    u = torch.linalg.solve_triangular(              # (R^T)^+ (C^+ A)^T
        rr, _mm(qr_.T, t.T, "highest"), upper=True).T
    return cols, rows, u


def id_reconstruct(a, cols, x):
    """A_k = A[:, cols] @ X (row-sharded where A is)."""
    a = _row_split(a)
    return _to_api(_mm(_like(a, _local(a).index_select(1, cols)), x))


def cur_reconstruct(a, cols, rows, u):
    """A_k = C @ U @ R (row-sharded where A is)."""
    a = _row_split(a)
    c = _like(a, _local(a).index_select(1, cols))
    return _to_api(_mm(_mm(c, u), _take_rows(a, rows)))


def _leverage(a, k, p, seed, axis):
    """(this rank's scores, the row-split U where they are split by A's
    rows, else None)."""
    a = _row_split(a)
    omega = driver.generate_omega(seed, a.shape[1], min(k + p, min(a.shape)),
                                  a.dtype, device=a.device)
    u, _, v = driver.rsvd_with_omega(a, omega, q=1, k=k, method="eigh")
    u = _sharded_view(u)
    basis = _local(u) if axis == 0 else v
    split = u if axis == 0 and isinstance(u, Sharded) else None
    return torch.sum(basis * basis, dim=1), split


def leverage_scores(a, k: int, p: int = 10, seed: int = 0,
                    axis: int = 0) -> torch.Tensor:
    """Approximate rank-k leverage scores along ``axis`` (0: rows, 1:
    columns): l_i = ||U_k[i, :]||^2 with U_k the top-k singular subspace
    from the rSVD range finder (q = 1, Gram-eigh tail).  Scores sum to
    ~k: the sampling weights behind leverage-based CUR/coresets
    (Mahoney-Drineas 2009).  Row scores of a row-sharded A come back
    row-sharded."""
    scores, split = _leverage(a, k, p, seed, axis)
    if split is None:
        return scores
    return row_dtensor(scores, split.mesh, split.rows, split.shape[0])


def gumbel_uniforms(seed: int, n: int, dtype, device):
    """The n uniforms in [1e-12, 1) behind :func:`leverage_sample`'s
    Gumbel noise, from a torch stream folded in from ``seed``."""
    gen = fold_in_shard(key_from_seed(seed, device), _GUMBEL_SALT)
    u = torch.rand((n,), generator=gen, dtype=dtype, device=gen.device)
    return 1e-12 + u * (1.0 - 1e-12)


def leverage_sample(a, k: int, num_samples: int, p: int = 10,
                    seed: int = 0, axis: int = 0):
    """Sample ``num_samples`` distinct indices along ``axis`` with
    probability proportional to their rank-k leverage scores: the
    standard coreset / importance-sampled CUR row (column) selection.
    Returns ``(indices: int64[num_samples], scores: full-axis)``.  Over
    the rows of a row-sharded A each rank keeps the top of its own rows
    (the Gumbel noise drawn whole), and the top of those candidates,
    gathered, is the sample."""
    scores, split = _leverage(a, k, p, seed, axis)
    n = split.shape[0] if split is not None else scores.shape[0]
    num = min(int(num_samples), n)
    # Gumbel top-k trick: distinct samples proportional to scores in one
    # vectorized pass (no sequential rejection loop)
    logits = torch.log(torch.clamp(scores, min=1e-30))
    gumbel = -torch.log(-torch.log(
        gumbel_uniforms(seed, n, scores.dtype, scores.device)))
    if split is None:
        _, idx = torch.topk(logits + gumbel, num)
        return idx, scores
    start = split.row_start
    keys, idx = torch.topk(
        logits + gumbel[start:start + scores.shape[0]],
        min(num, scores.shape[0]))
    keys = collectives.all_gather(keys, split.rows.group)
    idx = collectives.all_gather(idx + start, split.rows.group)
    _, best = torch.topk(keys, num)
    return idx[best], row_dtensor(scores, split.mesh, split.rows, n)
