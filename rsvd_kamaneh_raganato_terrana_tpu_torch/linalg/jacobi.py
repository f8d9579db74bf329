"""One-sided (Hestenes) Jacobi SVD with a round-robin tournament schedule
(the JAX package's ``linalg/jacobi.py``).

Each round of the circle-method tournament rotates n/2 disjoint column
pairs at once, applied as column updates (``apply='scatter'``) or as one
GEMM with the assembled orthogonal J (``apply='gemm'``).  A sweep is n-1
rounds; sweeps run until the largest normalized off-diagonal of W^T W
falls below ``tol``.

The block tournament (``apply='block'``, and ``'auto'`` above n = 512)
pairs column blocks instead of columns: each round solves its disjoint
2b x 2b block-pair problems with one batched eigh of the pair Grams
(``core/device.py::eigh``) and applies them as batched GEMMs, then a
gated scalar polish finishes.  ``jacobi_svd_chunked`` runs the same engine and reports every
sweep to a ``progress`` callback.

JAX's ``lax.while_loop`` becomes a Python loop with one scalar fetch per
sweep, never one per round: the rounds of a sweep are queued with no
host sync.  So the port's single-dispatch block engine has the chunked
driver's structure, and both run the same stage functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    eigh,
    matmul_at,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_sharded_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)

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


def _schedule(n: int, device):
    """``round_robin_schedule(n)`` as an index tensor on ``device``."""
    return torch.as_tensor(round_robin_schedule(n), dtype=torch.int64,
                           device=device)


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


def _apply_round_rutishauser(w, v, p_idx, q_idx, c, s):
    """The round's column updates, in place on w and v (the caller owns
    both), in Rutishauser's form: xp - s (xq + tau xp) and
    xq + s (xp - tau xq) with tau = s / (1 + c), each an ``addcmul``.
    For a small angle c rounds to 1, and the plain form (c xp - s xq,
    s xp + c xq) then grows both columns by up to t^2 / 2 a rotation,
    always upward; over the thousands of rotations of a sweep in f32
    that leaves V measurably non-orthogonal."""
    tau = s / (1.0 + c)
    for x in (w, v):
        xp, xq = x[:, p_idx], x[:, q_idx]
        x[:, p_idx] = torch.addcmul(xp, s, torch.addcmul(xq, tau, xp),
                                    value=-1.0)
        x[:, q_idx] = torch.addcmul(xq, s, torch.addcmul(xp, tau, xq,
                                                         value=-1.0))
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
    sched = _schedule(n, a.device)
    apply_fn = (_apply_round_gemm if apply == "gemm"
                else _apply_round_rutishauser)
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


def _block_round(w, v, pairs, b: int):
    """One tournament round of block rotations, in place on w and v (the
    caller owns both): the disjoint block pairs' 2b x 2b Grams go through
    one batched eigh, each eigenvector basis is aligned with the identity,
    and the pair panels are rotated by batched GEMMs."""
    m, n = w.shape
    nb = n // b
    p_idx, q_idx = pairs[:, 0], pairs[:, 1]
    wb = w.view(m, nb, b)
    vb = v.view(n, nb, b)
    # (npairs, rows, 2b) pair panels
    wp = torch.cat([wb[:, p_idx], wb[:, q_idx]], dim=2).permute(1, 0, 2)
    vp = torch.cat([vb[:, p_idx], vb[:, q_idx]], dim=2).permute(1, 0, 2)
    g = matmul_at(wp.transpose(1, 2), wp, DOT_PRECISION)
    # jnp.linalg.eigh symmetrizes its input; torch's reads one triangle
    _, qrot = eigh(0.5 * (g + g.transpose(1, 2)))
    # Identity alignment (JAX jacobi.py:250-274): eigh orders eigenvectors
    # by eigenvalue, which permutes columns across blocks every visit and
    # makes the cyclic iteration limit-cycle.  Send each eigenvector to the
    # row of its dominant component; where that assignment collides,
    # match the ascending eigenvalues to the ascending Gram diagonal.
    two_b = qrot.shape[-1]
    cand = torch.argmax(torch.abs(qrot), dim=1)            # (p, 2b)
    counts = torch.zeros_like(cand).scatter_add_(1, cand,
                                                 torch.ones_like(cand))
    is_perm = torch.all(counts == 1, dim=1)
    inv_cand = torch.argsort(cand, dim=1, stable=True)
    d = torch.diagonal(g, dim1=1, dim2=2)
    pos_order = torch.argsort(d, dim=1, stable=True)
    inv_diag = torch.argsort(pos_order, dim=1, stable=True)
    inv = torch.where(is_perm[:, None], inv_cand, inv_diag)
    qrot = torch.take_along_dim(qrot, inv[:, None, :].expand(-1, two_b, -1),
                                dim=2)
    qdiag = torch.diagonal(qrot, dim1=1, dim2=2)
    qrot = qrot * torch.where(qdiag < 0, -1.0, 1.0).to(qrot.dtype)[:, None, :]
    w_new = matmul_at(wp, qrot, DOT_PRECISION).permute(1, 0, 2)
    v_new = matmul_at(vp, qrot, DOT_PRECISION).permute(1, 0, 2)
    wb[:, p_idx] = w_new[:, :, :b]
    wb[:, q_idx] = w_new[:, :, b:]
    vb[:, p_idx] = v_new[:, :, :b]
    vb[:, q_idx] = v_new[:, :, b:]
    return w, v


def _block_prep(a, n_pad: int):
    """Norm presort (de Rijk's pivot order: each block then holds columns
    of similar scale), zero padding to ``n_pad`` columns; returns (W, the
    identity V, the presort's inverse permutation, the initial
    off-diagonal mass ratio)."""
    m, n_orig = a.shape
    order0 = torch.argsort(-torch.sum(a * a, dim=0), stable=True)
    inv_order0 = torch.argsort(order0, stable=True)
    w = torch.cat([a[:, order0], a.new_zeros((m, n_pad - n_orig))], dim=1)
    v = torch.eye(n_pad, dtype=a.dtype, device=a.device)
    return w, v, inv_order0, _offdiag_mass_ratio(w)


def _block_sweep(w, v, sched, b: int):
    """One block-tournament sweep; returns the factors and the post-sweep
    off-diagonal mass ratio (the block phase's measure)."""
    for pairs in sched:
        w, v = _block_round(w, v, pairs, b)
    return w, v, _offdiag_mass_ratio(w)


def _polish_sweep(w, v, sched):
    """One scalar-tournament sweep; returns the
    factors and the post-sweep max normalized off-diagonal (the polish
    phase's measure)."""
    eps_rel = torch.tensor(torch.finfo(w.dtype).eps, dtype=w.dtype,
                           device=w.device)
    for pairs in sched:
        p_idx, q_idx = pairs[:, 0], pairs[:, 1]
        c, s = _pair_rotations(w[:, p_idx], w[:, q_idx], eps_rel)
        w, v = _apply_round_rutishauser(w, v, p_idx, q_idx, c, s)
    return w, v, _max_normalized_offdiag(w)


def _block_finish(w, v, inv_order, n_orig: int):
    """Sort by column norm, keep the ``n_orig`` largest (block rotations
    move the zero pad columns anywhere in their pair) and un-permute V's
    rows (A P = U S V_p^T, so A = U S (P V_p)^T)."""
    s = torch.sqrt(torch.sum(w * w, dim=0))
    order = torch.argsort(-s, stable=True)[:n_orig]
    s, w = s[order], w[:, order]
    v = v[:n_orig, order][inv_order]
    safe = torch.clamp(s, min=torch.finfo(w.dtype).tiny)
    u = torch.where(s[None, :] > 0, w / safe[None, :], torch.zeros_like(w))
    return u, s, v


def _block_jacobi_core(a, tol, max_sweeps: int, block_size: int,
                       progress=None):
    """(U, s, V, block sweeps) of A by the block tournament: block sweeps
    until the off-diagonal mass ratio is below ``tol`` or a sweep shrinks
    it by less than 1% (the floor is the dtype's pair-eigh accuracy), then
    scalar polish sweeps until the max normalized off-diagonal is below
    ``tol`` (none when the block phase got there): the pair eigh cannot
    resolve singular values below eps * (s_max_in_pair / s_i)^2, scalar
    rotations are per-pair scale invariant.  Each phase fetches one flag
    per sweep; ``progress(phase, sweep, measure)`` is called after each
    sweep when given."""
    n_orig = a.shape[1]
    b = block_size
    nb = -(-n_orig // b)
    nb += nb % 2                       # even block count for the tournament
    w, v, inv_order0, off = _block_prep(a, nb * b)
    sched = _schedule(nb, a.device)
    prev = torch.full_like(off, float("inf"))
    sweeps = 0
    while sweeps < max_sweeps and bool((off > tol) & (off < prev * 0.99)):
        prev = off
        w, v, off = _block_sweep(w, v, sched, b)
        sweeps += 1
        if progress is not None:
            progress("block", sweeps, float(off))
    sched_s = _schedule(nb * b, a.device)
    off_max = _max_normalized_offdiag(w)
    i = 0
    while i < max_sweeps and bool(off_max > tol):
        w, v, off_max = _polish_sweep(w, v, sched_s)
        i += 1
        if progress is not None:
            progress("polish", i, float(off_max))
    u, s, v = _block_finish(w, v, inv_order0, n_orig)
    return u, s, v, sweeps


def _auto_apply(n: int) -> str:
    """The JAX package's measured engine crossover: GEMM rounds up to
    n = 256, scatter up to 512, the block tournament above."""
    if n <= 256:
        return "gemm"
    if n <= 512:
        return "scatter"
    return "block"


@row_sharded_api
def jacobi_svd(a, tol: Optional[float] = None, max_sweeps: int = 60,
               apply: str = "auto", precondition: bool = True,
               block_size: int = 64):
    """Full SVD A = U diag(s) V^T by one-sided tournament Jacobi: U m x k,
    s descending, V n x k with k = min(m, n).  ``apply``: 'gemm' (rotation
    rounds as GEMMs), 'scatter' (column updates), 'block' (the block
    tournament over ``block_size``-wide column blocks, then the scalar
    polish) or 'auto' (the JAX package's crossover, :func:`_auto_apply`).
    Tall inputs are preconditioned with a robust thin QR, so the sweeps
    run on the square R factor; wide inputs are factored transposed.  A
    tall or square row-split matrix (``core/distributed.py::Sharded``;
    at the API a DTensor whose rows are sharded) takes the QR of its
    row-split panel (all-reduced Gram) and keeps U row-split."""
    return _jacobi_svd(a, tol, max_sweeps, apply, precondition, block_size)


def jacobi_svd_chunked(a, tol: Optional[float] = None, max_sweeps: int = 60,
                       block_size: int = 64, precondition: bool = True,
                       progress=None):
    """``jacobi_svd(apply='block')`` with every sweep reported:
    ``progress(phase, sweep, measure)`` is called after each block sweep
    (phase 'block', the off-diagonal mass ratio) and each polish sweep
    ('polish', the max normalized off-diagonal).  The same stages and
    stopping rules as the block engine, which in the port also fetches
    one flag per sweep (module docstring)."""
    return _jacobi_svd(a, tol, max_sweeps, "block", precondition,
                       block_size, progress)


def _jacobi_svd(a, tol, max_sweeps: int, apply: str, precondition: bool,
                block_size: int, progress=None):
    m, n = a.shape
    split = isinstance(a, Sharded)
    if split and (a.transposed or m < n or not precondition):
        raise ValueError("a row-split matrix is factored through its thin "
                         "QR: a tall or square one with precondition=True")
    if m < n:
        u, s, v = _jacobi_svd(a.T, tol, max_sweeps, apply, precondition,
                              block_size, progress)
        return v, s, u
    if tol is None:
        tol = 30.0 * float(torch.finfo(a.dtype).eps)
    if apply == "auto":
        apply = _auto_apply(n)

    def core(x):
        if apply == "block":
            return _block_jacobi_core(x, tol, max_sweeps,
                                      min(block_size, x.shape[1]), progress)
        return _jacobi_core(x, tol, max_sweeps, apply)

    if precondition and (m > n or split):
        # thin QR first: the sweeps then run on the n x n R factor
        q0, r0 = qr_reduced(a, "robust")
        ur, s, v, _ = core(r0)
        if isinstance(q0, Sharded):
            return q0.with_local(matmul_at(q0.local, ur, DOT_PRECISION)), \
                s, v
        return matmul_at(q0, ur, DOT_PRECISION), s, v
    u, s, v, _ = core(a)
    return u, s, v
