"""Robust PCA (principal component pursuit; the JAX package's
``rsvd/rpca.py``): M = L + S with L low-rank and S sparse, by inexact
augmented Lagrange multipliers (Lin, Chen & Ma 2010; Candes et al.
2011):

    L = D_{1/mu}(M - S + Y/mu)     (singular-value soft threshold)
    S = shrink_{lambda/mu}(M - L + Y/mu)
    Y = Y + mu (M - L - S),  mu <- rho mu

The SVT step is the driver's randomized rank-``k_max`` projection
(``rsvd_with_omega``, 'eigh' tail, reorth 'half') with soft-thresholded
singular values.  The iterations are a Python loop over device tensors:
mu stays a device scalar, the residual trace is written by index, and
no step branches on a tensor.  The host syncs of a call are those of
the driver's 'robust' QR fallback flag.  Iteration i's sketch comes
from the seed's generator folded with i, the sigma_1 estimate's from
the fold with 0x51e17 (the JAX package's tags; torch Philox draws).

A DTensor whose rows are sharded is read block by block: L, S and Y
stay row-split, every norm and max over them is local and all-reduced,
and the products and the SVT's range finder go through the driver's
split products, the sketches drawn whole, as on one card.  L and S come
back row-sharded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _reduce,
    _row_split,
    _sharded_view,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    rsvd_with_omega,
)

_SIGMA_TAG = 0x51e17


class RpcaResult(NamedTuple):
    low_rank: torch.Tensor   # L (m x n)
    sparse: torch.Tensor     # S (m x n)
    rank: torch.Tensor       # numerical rank of L (post-threshold)
    resid: torch.Tensor      # ||M - L - S||_F / ||M||_F per iteration


def _svt(x, tau, key, k_max: int, p: int, q: int, precision):
    """Randomized singular-value soft-thresholding D_tau(x), truncated to
    rank k_max: the driver's range finder and tail ('half' reorth) with a
    soft-thresholded spectrum.  For a row-split x, this rank's rows of
    the result."""
    l = min(k_max + p, min(x.shape))
    omega = sketch_matrix(key, x.shape[1], l, x.dtype)
    u, s, v = rsvd_with_omega(x, omega, q=q, k=k_max, method="eigh",
                              precision=precision, reorth="half")
    s_sh = torch.clamp(s - tau, min=0.0)
    return _mm(_local(_sharded_view(u)) * s_sh[None, :], v.T), s_sh


def rpca(
    m_mat,
    k_max: int = 32,
    iters: int = 40,
    lam: float | None = None,
    mu: float | None = None,
    rho: float = 1.6,
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    precision: str = "highest",
) -> RpcaResult:
    """Principal component pursuit: M ~ L (rank <= k_max) + S (sparse).

    Defaults are the IALM schedule (Lin, Chen & Ma 2010, Alg. 5):
    lam = 1/sqrt(max(m, n)), Y0 = M / J(M) with
    J(M) = max(sigma_1, ||M||_inf / lam), mu0 = 1.25/sigma_1,
    mu <- rho mu (rho = 1.6).  A tensor stays on its device; any other
    array goes to the card; a DTensor whose rows are sharded is read
    block by block (the module docstring)."""
    view = _row_split(m_mat)
    mm, nn = view.shape
    dtype, dev = view.dtype, view.device
    m_mat = _local(view)                     # this rank's rows

    def norm(x):                             # Frobenius, over every rank
        return torch.sqrt(_reduce(torch.sum(x * x), view))

    def split(x):
        return _like(view, x)
    norm_f = norm(m_mat)
    lam_v = (1.0 / torch.sqrt(torch.tensor(float(max(mm, nn)),
                                           dtype=dtype, device=dev))
             if lam is None else torch.tensor(lam, dtype=dtype, device=dev))
    key = key_from_seed(seed, dev)
    # sigma_1 estimate: a few power iterations
    v1 = sketch_matrix(fold_in_shard(key, _SIGMA_TAG), nn, 1, dtype)
    for _ in range(8):
        v1 = _mm(view.T, _mm(view, v1))
        v1 = v1 / torch.clamp(torch.linalg.norm(v1), min=1e-30)
    sigma1 = norm(_local(_mm(view, v1)))
    mu_i = (1.25 / torch.clamp(sigma1, min=1e-30) if mu is None
            else torch.tensor(mu, dtype=dtype, device=dev))

    low = sp = torch.zeros_like(m_mat)
    m_inf = _reduce(torch.max(torch.abs(m_mat)), view, "max")
    j_scale = torch.maximum(sigma1, m_inf / lam_v)
    y = m_mat / torch.clamp(j_scale, min=1e-30)
    resid = m_mat.new_zeros((iters,))
    for i in range(iters):
        low, _ = _svt(split(m_mat - sp + y / mu_i), 1.0 / mu_i,
                      fold_in_shard(key, i), k_max, p, q, precision)
        g = m_mat - low + y / mu_i
        sp = torch.sign(g) * torch.clamp(torch.abs(g) - lam_v / mu_i,
                                         min=0.0)
        r = m_mat - low - sp
        y = y + mu_i * r
        resid[i] = norm(r) / norm_f
        mu_i = mu_i * rho
    # numerical rank of the recovered L
    _, s_fin = _svt(split(low), 0.0, fold_in_shard(key, iters), k_max, p,
                    q, precision)
    tol = torch.clamp(s_fin[0], min=1e-30) * 1e-6
    return RpcaResult(_to_api(split(low)), _to_api(split(sp)),
                      torch.sum(s_fin > tol), resid)
