"""Low-rank matrix completion by Singular Value Projection (the JAX
package's ``rsvd/completion.py``; Jain, Meka & Dhillon 2010):

    X_{t+1} = P_k( X_t + eta * P_Omega(A - X_t) ),

P_k the rank-k projection by the driver's randomized range finder and
tail, with a fresh sketch each iteration (the seed's generator folded
with i; torch Philox draws).  As in the JAX package: the adaptive NIHT
step (Tanner & Wei 2013) unless ``eta`` is given, a backtracking
safeguard that accepts a step only when the observed RMSE does not
grow, and a two-sided ALS debias after each projection (the n and m
k x k normal-equation systems on the observed entries, batched).

The iterations are a Python loop over device tensors: the accept test
is ``torch.where`` on the device, the RMSE trace is written by index,
and no step branches on a tensor; the host syncs of a call are those of
the driver's 'robust' QR fallback flag.  ``complete_tucker`` runs the
same scheme on tensors with the randomized Tucker of ``rsvd/tucker.py``
as the projection.

``complete_lowrank`` takes a DTensor whose rows are sharded, with the
mask sharded like it (or whole on every rank): the m x n iterates stay
row-split, every sum over them is local and all-reduced, the
projections and the column fit go through the driver's split products,
the m x k row fit is local, and its k-column SVD runs on the gathered
m x k panel.  The sketches are drawn whole, as on one card.  U comes
back row-sharded, s, V and the trace replicated.  ``complete_tucker``
takes a tensor sharded on mode 0 the same way (its docstring).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    is_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _reduce,
    _row_block,
    _row_split,
    _sharded_view,
    _to_api,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    rsvd_with_omega,
)


class CompletionResult(NamedTuple):
    u: torch.Tensor          # m x k
    s: torch.Tensor          # k
    v: torch.Tensor          # n x k
    obs_rmse: torch.Tensor   # RMSE on observed entries per iteration (iters,)


def _rank_k_project(x, key, k: int, p: int, q: int, precision):
    """P_k(x): the driver's range finder and tail with a fresh sketch
    ('half' reorth: interior bases only need conditioning here); U as
    the driver's view (a row split where x is one)."""
    l = min(k + p, min(x.shape))
    omega = sketch_matrix(key, x.shape[1], l, x.dtype)
    u, s, v = rsvd_with_omega(x, omega, q=q, k=k, method="eigh",
                              precision=precision, reorth="half")
    return _sharded_view(u), s, v


def _masked_grams(basis, maskf, lam, eye_k):
    """For each column j of the mask (maskf: rows x cols), the k x k Gram
    sum_i mask_ij b_i b_i^T of the rows b_i of ``basis`` (rows x k), as
    one GEMM over the k^2 pairwise products, plus the Tikhonov floor
    lam * max(trace, 1) I.  Either may be split by rows (the driver's
    split product of maskf^T and the pairs); the Grams come back for
    this rank's columns of maskf."""
    b = _local(basis)
    rows, k = b.shape
    pairs = _like(basis, (b[:, :, None] * b[:, None, :]).reshape(rows, k * k))
    gram = _local(_mm(maskf.T, pairs, "highest")).reshape(-1, k, k)
    scale = torch.clamp(torch.diagonal(gram, dim1=1, dim2=2).sum(-1),
                        min=1.0)
    return gram + (lam * scale)[:, None, None] * eye_k


def complete_lowrank(
    a_obs,
    mask,
    k: int,
    iters: int = 30,
    eta: float | None = None,
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    precision: str = "highest",
) -> CompletionResult:
    """Rank-k completion of a partially observed matrix.

    a_obs: m x n with arbitrary values outside the mask (never read);
    mask: bool m x n, True = observed.  Returns the factor form (U, s, V)
    of the completed matrix and the observed-RMSE trace.  eta=None
    (default) takes the adaptive NIHT step; a float fixes it.  A tensor
    stays on its device; any other array goes to the card; a DTensor
    whose rows are sharded is read block by block (the module
    docstring)."""
    a_obs = _row_split(a_obs)
    mask = _row_block(a_obs, _row_split(mask) if is_dtensor(mask)
                      else as_tensor(mask, device=a_obs.device))
    mask = mask.to(torch.bool)
    m, n = a_obs.shape
    dtype, dev = a_obs.dtype, a_obs.device
    n_obs = torch.clamp(_reduce(torch.sum(mask), a_obs), min=1).to(dtype)
    frac = n_obs / (m * n)
    adaptive = eta is None
    eta0 = (2.0 / frac) if adaptive else torch.tensor(eta, dtype=dtype,
                                                      device=dev)
    # every m-row tensor below is this rank's rows; the split views wrap
    # them for the driver's products
    a_local = _local(a_obs)
    a_masked = torch.where(mask, a_local, torch.zeros_like(a_local))
    masked = _like(a_obs, a_masked)
    key = key_from_seed(seed, dev)
    maskf = _like(a_obs, mask.to(dtype))
    # Tikhonov floor for the per-row/column normal equations, relative to
    # each Gram's own diagonal scale
    lam = 1e-8
    kk = min(k, m, n)
    eye_k = torch.eye(kk, dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny

    def total(t):
        return _reduce(torch.sum(t), a_obs)

    def obs_rmse_at(x):
        resid = torch.where(mask, a_masked - x, torch.zeros_like(x))
        return torch.sqrt(total(resid * resid) / n_obs), resid

    def fit_cols(u):
        """The n x k coefficients minimizing the observed residual of
        u @ W^T: n k x k normal-equation solves, batched."""
        gram = _masked_grams(u, maskf, lam, eye_k)
        return torch.linalg.solve(gram, _mm(masked.T, u)[..., None])[..., 0]

    def fit_rows(v):
        """The m x k coefficients minimizing the observed residual of
        Z @ v^T (this rank's rows)."""
        gram = _masked_grams(v, maskf.T, lam, eye_k)
        return torch.linalg.solve(
            gram, _local(_mm(masked, v))[..., None])[..., 0]

    u = a_local.new_zeros((a_local.shape[0], kk))
    s = a_local.new_zeros((kk,))
    v = a_local.new_zeros((n, kk))
    x = torch.zeros_like(a_local)
    boost = torch.ones((), dtype=dtype, device=dev)
    rmse = a_local.new_zeros((iters,))
    for i in range(iters):
        r_cur, resid = obs_rmse_at(x)
        rmse[i] = r_cur
        if adaptive:
            # NIHT: exact line search along the gradient restricted to
            # the current column space; i = 0 has no basis yet and takes
            # the 2/p step
            if i == 0:
                eta_n = eta0
            else:
                g_t = _mm(u, _mm(_like(a_obs, u).T, _like(a_obs, resid)))
                num = total(g_t * g_t)
                den = total(torch.where(mask, g_t,
                                        torch.zeros_like(g_t)) ** 2)
                eta_n = torch.where(den > 0,
                                    num / torch.clamp(den, min=tiny), eta0)
            eta_i = boost * torch.minimum(torch.clamp(eta_n, min=1.0),
                                          4.0 * eta0)
        else:
            eta_i = boost * eta0
        cu, _, _ = _rank_k_project(_like(a_obs, x + eta_i * resid),
                                   fold_in_shard(key, i), k, p, q, precision)
        # two-sided ALS debias: refit the coefficients on the observed
        # entries for the projected column basis, orthonormalize, refit
        # the row side, back to SVD form by the k x k SVD
        qw, _ = torch.linalg.qr(fit_cols(cu))   # n x k orthonormal
        z = _like(a_obs, fit_rows(qw))           # m x k
        cu, cs, vz_t = torch.linalg.svd(_whole(z), full_matrices=False)
        cu = _row_block(a_obs, cu)
        cv = _mm(qw, vz_t.T)
        cx = _mm(cu * cs[None, :], cv.T)
        r_new, _ = obs_rmse_at(cx)
        ok = r_new <= r_cur
        u = torch.where(ok, cu, u)
        s = torch.where(ok, cs, s)
        v = torch.where(ok, cv, v)
        x = torch.where(ok, cx, x)
        boost = torch.where(ok, torch.clamp(1.2 * boost, max=1.0),
                            0.5 * boost)
    return CompletionResult(_to_api(_like(a_obs, u)), s, v, rmse)


class TuckerCompletionResult(NamedTuple):
    core: torch.Tensor
    factors: Tuple[torch.Tensor, ...]
    obs_rmse: torch.Tensor


def complete_tucker(
    a_obs,
    mask,
    ranks: Tuple[int, ...],
    iters: int = 30,
    eta: float | None = None,
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    precision: str = "highest",
) -> TuckerCompletionResult:
    """Low-multilinear-rank TENSOR completion: the same SVP projected
    gradient with the randomized Tucker (ST-HOSVD) as the projection
    P_ranks, a fresh sketch each iteration (seed + 1 + i), and the
    backtracking safeguard of :func:`complete_lowrank`.  Returns (core,
    factors, observed-RMSE trace).

    Keeps the plain fixed-step + backtracking SVP scheme: the matrix
    path's NIHT step and two-sided ALS debias have no cheap Tucker
    analogue, so expect SVP-rate convergence here.  A tensor stays on
    its device; any other array goes to the card.  A DTensor sharded on
    mode 0, with the mask sharded like it (or whole), runs through the
    sharded Tucker of ``rsvd/tucker.py``: the iterates stay split on
    mode 0, every sum over them is local and all-reduced, U_0 comes back
    row-sharded, the core, the other factors and the trace
    replicated."""
    from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker import (
        tucker,
        tucker_reconstruct,
    )

    a_obs = _row_split(a_obs)
    mask = _row_block(a_obs, _row_split(mask) if is_dtensor(mask)
                      else as_tensor(mask, device=a_obs.device))
    mask = mask.to(torch.bool)
    ranks = tuple(ranks)
    dtype, dev = a_obs.dtype, a_obs.device
    n_obs = torch.clamp(_reduce(torch.sum(mask), a_obs), min=1).to(dtype)
    frac = n_obs / math.prod(a_obs.shape)
    eta_v = (1.0 / frac) if eta is None else torch.tensor(
        eta, dtype=dtype, device=dev)
    a_local = _local(a_obs)
    a_masked = torch.where(mask, a_local, torch.zeros_like(a_local))

    def total(t):
        return _reduce(torch.sum(t), a_obs)

    def obs_rmse_at(x):
        resid = torch.where(mask, a_masked - x, torch.zeros_like(x))
        return torch.sqrt(total(resid * resid) / n_obs), resid

    def project(t, sd):
        """Tucker of the tensor whose block (split on mode 0) is ``t``:
        (core, factors), U_0 as this rank's rows."""
        if isinstance(a_obs, Sharded):
            t = Sharded(t, a_obs.shape, a_obs.mesh, a_obs.rows)
        core, factors = tucker(t, ranks, p=p, q=q, seed=sd,
                               precision=precision)
        return core, (_local(_sharded_view(factors[0])),) + factors[1:]

    core, factors = project(eta_v * a_masked, seed)
    rmse = a_local.new_zeros((iters,))
    rmse[0] = torch.sqrt(total(a_masked * a_masked) / n_obs)
    x = tucker_reconstruct(core, factors)
    eta_i = eta_v * torch.ones((), dtype=dtype, device=dev)
    for i in range(1, iters):
        r_cur, resid = obs_rmse_at(x)
        rmse[i] = r_cur
        c_core, c_factors = project(x + eta_i * resid, seed + 1 + i)
        cx = tucker_reconstruct(c_core, c_factors)
        r_new, _ = obs_rmse_at(cx)
        ok = r_new <= r_cur
        core = torch.where(ok, c_core, core)
        factors = tuple(torch.where(ok, cf, f)
                        for cf, f in zip(c_factors, factors))
        x = torch.where(ok, cx, x)
        eta_i = torch.where(ok, torch.minimum(1.2 * eta_i, eta_v),
                            0.5 * eta_i)
    factors = (_to_api(_like(a_obs, factors[0])),) + factors[1:]
    return TuckerCompletionResult(core, factors, rmse)
