"""Randomized rank-revealing UTV (powerURV) and the sigma rescore of the
UTV finishes (the JAX package's ``rsvd/utv.py``).

A ~ U T V^T with U, V orthonormal and T upper-triangular (Gopal &
Martinsson 2018): V = range finder of A^T, W = A V, (U, T) = qr(W).  The
approximation error is the range finder's ||A (I - V V^T)||.
"""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _as_operand,
    _mm,
    generate_omega,
    subspace_iteration,
)


def rutv(a, k: int = 0, p: int = 10, q: int = 2, seed: int = 0,
         qr_method: str = "robust", precision: str = "highest"):
    """Randomized UTV: returns (U: m x l, T: l x l upper-triangular with
    positive diagonal, V: n x l), l = k + p (all l = p when k = 0).
    A ~ U @ T @ V.T; truncate with :func:`rutv_reconstruct`.  Omega
    (m x l) is drawn from ``seed`` on A's device."""
    a = _as_operand(a)
    m, n = a.shape
    l = min(k + p if k > 0 else p, min(m, n))
    omega = generate_omega(seed, m, l, a.dtype, device=a.device)
    v = subspace_iteration(a.T, omega, q, qr_method, precision)   # n x l
    w = _mm(a, v, precision)                                      # m x l
    u, t = qr_reduced(w, qr_method)                               # A V = U T
    # positive diagonal of T, so diag(T) compares with singular values
    signs = torch.where(torch.diagonal(t) < 0, -1.0, 1.0).to(a.dtype)
    return u * signs[None, :], t * signs[:, None], v


def rutv_reconstruct(u, t, v, k: int = 0):
    """A_k = U[:, :k] T[:k, :] V^T (the full l-rank product when k = 0)."""
    if k and k > 0:
        u, t = u[:, :k], t[:k, :]
    return _mm(_mm(u, t), v.T)


def utv_rescore(u, s, v):
    """Exact SVD of a UTV-finish approximant M = U diag(s) V^T, off the
    serving path: G = diag(s) U^T U diag(s) -> eigh -> (sigma^2, W),
    U* = U diag(s) W / sigma, V* = V W.  Returns (U*, sigma descending,
    V*); directions whose sigma sits at the roundoff floor are zeroed
    rather than normalized noise."""
    f = u * s[None, :]
    g = _mm(f.T, f)
    lam, w = torch.linalg.eigh(g)                   # ascending
    lam = torch.clamp(lam.flip(0), min=0.0)
    w = w.flip(1)
    sigma = torch.sqrt(lam)
    tiny = torch.finfo(u.dtype).tiny
    safe = torch.clamp(sigma, min=tiny)
    u_true = _mm(f, w / safe[None, :])
    live = lam > torch.clamp(torch.finfo(u.dtype).eps * lam[0], min=tiny)
    u_true = torch.where(live[None, :], u_true, torch.zeros_like(u_true))
    return u_true, sigma, _mm(v, w)
