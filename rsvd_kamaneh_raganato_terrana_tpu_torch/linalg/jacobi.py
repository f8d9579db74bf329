"""One-sided (Hestenes) Jacobi SVD with a round-robin tournament schedule
(the JAX package's ``linalg/jacobi.py``, without its block engine).

Each round of the circle-method tournament rotates n/2 disjoint column
pairs at once, applied as column updates (``apply='scatter'``) or as one
GEMM with the assembled orthogonal J (``apply='gemm'``).  A sweep is n-1
rounds; sweeps run until the largest normalized off-diagonal of W^T W
falls below ``tol``.  JAX's ``lax.while_loop`` becomes a Python loop
with one scalar fetch per sweep; the rounds of a sweep are queued with
no host sync.

The block tournament (``apply='block'``, and ``'auto'`` above n = 512)
and the chunked block driver ``jacobi_svd_chunked`` are not ported yet
(ROADMAP.md, queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)

#: the largest n that ``_auto_apply`` serves without the block engine
BLOCK_ENGINE_ABOVE = 512


def make_jacobi(x, y, z):
    """Symmetric Schur rotation (c, s) annihilating the off-diagonal y of
    the 2x2 symmetric [[x, y], [y, z]]."""
    x, y, z = (torch.as_tensor(t) for t in (x, y, z))
    tau = (z - x) / (2.0 * torch.where(y == 0, torch.ones_like(y), y))
    w = torch.sqrt(tau * tau + 1.0)
    t = torch.where(tau > 0, 1.0 / (tau + w), 1.0 / (tau - w))
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    c = torch.where(y == 0, torch.ones_like(c), c)
    s = torch.where(y == 0, torch.zeros_like(s), s)
    return c, s


def givens_rotation(a, b):
    """(c, s, r) with [[c, s], [-s, c]]^T [a, b] = [r, 0]."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    r = torch.hypot(a, b)
    safe = torch.where(r == 0, torch.ones_like(r), r)
    c = torch.where(r == 0, torch.ones_like(a), a / safe)
    s = torch.where(r == 0, torch.zeros_like(b), b / safe)
    return c, s, r


def round_robin_schedule(n: int) -> np.ndarray:
    """Circle-method tournament: (n_eff-1) rounds of n_eff/2 disjoint pairs
    covering all unordered pairs exactly once (n_eff = n rounded up to
    even; pairs touching the phantom index are masked with index n)."""
    n_eff = n + (n % 2)
    players = list(range(n_eff))  # index n (if present) is the bye marker
    rounds = []
    for _ in range(n_eff - 1):
        pairs = [
            (players[i], players[n_eff - 1 - i]) for i in range(n_eff // 2)
        ]
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    sched = np.asarray(rounds, dtype=np.int32)  # (n_eff-1, n_eff//2, 2)
    if n % 2:
        # mark bye pairs: any pair containing the phantom index n
        mask = (sched == n).any(axis=-1)
        sched = np.where(mask[..., None], n, sched)  # whole pair -> n
    return sched


def _pair_rotations(wp, wq, eps_rel):
    """Closed-form Hestenes rotations for a batch of column pairs: (c, s)
    such that (c wp - s wq, s wp + c wq) annihilates the Gram cross-term."""
    alpha = torch.sum(wp * wp, dim=0)
    beta = torch.sum(wq * wq, dim=0)
    gamma = torch.sum(wp * wq, dim=0)
    do_rot = gamma * gamma > (eps_rel * eps_rel) * alpha * beta
    safe_gamma = torch.where(do_rot, gamma, torch.ones_like(gamma))
    zeta = (beta - alpha) / (2.0 * safe_gamma)
    # a zero-safe sign: equal column norms still need the 45-degree turn
    sgn = torch.where(zeta >= 0, 1.0, -1.0).to(zeta.dtype)
    t = sgn / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
    t = torch.where(do_rot, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, c * t


def _apply_round_scatter(w, v, p_idx, q_idx, c, s):
    """The round's column updates, in place on w and v (the caller owns
    both)."""
    for x in (w, v):
        xp, xq = x[:, p_idx], x[:, q_idx]
        x[:, p_idx] = c * xp - s * xq
        x[:, q_idx] = s * xp + c * xq
    return w, v


def _apply_round_gemm(w, v, p_idx, q_idx, c, s):
    """Assemble the n/2 disjoint rotations into one orthogonal J and apply
    it with two GEMMs."""
    n = w.shape[1]
    j = torch.eye(n, dtype=w.dtype, device=w.device)
    j[p_idx, p_idx] = c
    j[q_idx, q_idx] = c
    j[p_idx, q_idx] = s
    j[q_idx, p_idx] = -s
    return matmul_at(w, j, DOT_PRECISION), matmul_at(v, j, DOT_PRECISION)


def _offdiag_mass_ratio(w):
    """sqrt(off-diagonal mass / diagonal mass) of W^T W (the block
    engine's convergence measure)."""
    g = matmul_at(w.T, w, DOT_PRECISION)
    d = torch.diagonal(g)
    diag_mass = torch.sum(d * d)
    off_mass = torch.clamp(torch.sum(g * g) - diag_mass, min=0.0)
    return torch.sqrt(off_mass / torch.clamp(
        diag_mass, min=torch.finfo(w.dtype).tiny))


def _max_normalized_offdiag(w):
    """max_{i!=j} |w_i . w_j| / (||w_i|| ||w_j||) -- the per-pair
    convergence measure."""
    g = matmul_at(w.T, w, DOT_PRECISION)
    d = torch.diagonal(g)
    tiny = torch.finfo(w.dtype).tiny
    dn = torch.where(d > tiny, torch.rsqrt(torch.clamp(d, min=tiny)),
                     torch.zeros_like(d))
    gn = g * dn[:, None] * dn[None, :]
    gn = gn - torch.diag(torch.diagonal(gn))
    return torch.max(torch.abs(gn))


def _jacobi_core(a, tol, max_sweeps: int, apply: str):
    """(U, s, V, sweeps) of A by scalar tournament sweeps."""
    m, n_orig = a.shape
    dtype = a.dtype
    # odd widths get one zero pad column (identity rotations), sliced off
    # before the final sort; the copy leaves the caller's A untouched
    w = torch.cat([a, a.new_zeros((m, n_orig % 2))], dim=1)
    n = w.shape[1]
    eps_rel = torch.tensor(torch.finfo(dtype).eps, dtype=dtype,
                           device=a.device)
    sched = torch.as_tensor(round_robin_schedule(n), dtype=torch.int64,
                            device=a.device)
    apply_fn = _apply_round_gemm if apply == "gemm" else _apply_round_scatter
    v = torch.eye(n, dtype=dtype, device=a.device)
    sweeps = 0
    off = _max_normalized_offdiag(w)
    while sweeps < max_sweeps and bool(off > tol):      # one fetch per sweep
        for pairs in sched:
            p_idx, q_idx = pairs[:, 0], pairs[:, 1]
            c, s = _pair_rotations(w[:, p_idx], w[:, q_idx], eps_rel)
            w, v = apply_fn(w, v, p_idx, q_idx, c.to(dtype), s.to(dtype))
        sweeps += 1
        off = _max_normalized_offdiag(w)
    w = w[:, :n_orig]
    v = v[:n_orig, :n_orig]
    # singular values = column norms, descending; U, V permuted alike
    s = torch.sqrt(torch.sum(w * w, dim=0))
    order = torch.argsort(-s, stable=True)
    s, w, v = s[order], w[:, order], v[:, order]
    safe = torch.clamp(s, min=torch.finfo(dtype).tiny)
    u = torch.where(s[None, :] > 0, w / safe[None, :], torch.zeros_like(w))
    return u, s, v, sweeps


def _auto_apply(n: int) -> str:
    """The JAX package's measured engine crossover: GEMM rounds up to
    n = 256, scatter up to 512, the block tournament above."""
    if n <= 256:
        return "gemm"
    if n <= BLOCK_ENGINE_ABOVE:
        return "scatter"
    return "block"


def jacobi_svd(a, tol: Optional[float] = None, max_sweeps: int = 60,
               apply: str = "auto", precondition: bool = True,
               block_size: int = 64):
    """Full SVD A = U diag(s) V^T by one-sided tournament Jacobi: U m x k,
    s descending, V n x k with k = min(m, n).  ``apply``: 'gemm' (rotation
    rounds as GEMMs), 'scatter' (column updates) or 'auto' (the JAX
    package's crossover, :func:`_auto_apply`).  Tall inputs are
    preconditioned with a robust thin QR, so the sweeps run on the square
    R factor; wide inputs are factored transposed.  ``block_size`` keeps
    the JAX signature: it sizes the block engine, which is not ported
    yet, so ``apply='block'`` (or 'auto' with min(m, n) > 512) raises
    ``NotImplementedError``."""
    m, n = a.shape
    if m < n:
        u, s, v = jacobi_svd(a.T, tol, max_sweeps, apply, precondition,
                             block_size)
        return v, s, u
    if apply == "auto":
        apply = _auto_apply(n)
    if apply == "block":
        raise NotImplementedError(
            f"the block Jacobi engine (apply='block', chosen by 'auto' for "
            f"n > {BLOCK_ENGINE_ABOVE}) is not ported to the PyTorch "
            "package yet (ROADMAP.md, queue 1); use apply='scatter' or "
            "'gemm'")
    if tol is None:
        tol = 30.0 * float(torch.finfo(a.dtype).eps)
    if precondition and m > n:
        # thin QR first: the sweeps then run on the n x n R factor
        q0, r0 = qr_reduced(a, "robust")
        ur, s, v, _ = _jacobi_core(r0, tol, max_sweeps, apply)
        return matmul_at(q0, ur, DOT_PRECISION), s, v
    u, s, v, _ = _jacobi_core(a, tol, max_sweeps, apply)
    return u, s, v
