"""The plain ST-HOSVD in f64: the semantics of the port's ``tucker`` (its
docstring), computed here with plain torch from the held tensor.

For each mode in turn, largest first (stable), on the current tensor X
(the held tensor, then the cores contracted so far), with its mode
unfolding X_(i) (n_i x rest):

- l = min(r_i + p, n_i, rest), Omega the port's documented draw for
  the mode (``draw_omega(seed + 7919 i, rest, l)``, ``rsvd_f64``);
- Y = X_(i) Omega, Q = orth(Y); q power rounds Z = X_(i)^T Q,
  Q = orth(X_(i) orth(Z));
- the top r_i eigenvectors V of (Q^T X_(i))(Q^T X_(i))^T, U_i = Q V;
- X = U_i^T X_(i) folded back, mode i now of size r_i.

Each step depends on the range of its basis alone, so any orthonormal
basis serves: Householder QR for the n_i x l panels, and for the tall
rest x l panel Z the basis Z T with T = W diag(w)^(-1/2) from the
eigenpairs (w, W) of Z^T Z, so that Z is never held whole.  The
unfolding is read in chunks of its columns, each widened to f64 as it
is read; the held f32 tensor's mode-0 unfolding is a view of it, so
the 37 GB tensor is never copied.  What is held is Omega (f32, as the
program draws it), the n_i x l panels and each contracted core (f64).

An eigenvector's sign is free, but it changes every later mode's
sketch (a column of the next unfolding flips, so it meets another row
of Omega): ``gauge``, a factor per mode, turns each column of U_i to
the side of the same column of the given factor.  The readings pass
the program's factors, and the control the reference's.

``numerics``: ``exact`` (the held f32 values, every product in f64) or
``tf32`` (a control: the tensor, each core and every panel a product
reads rounded to TF32 by ``quant.tf32``, as a TF32 product would read
them, U_i = Q V among them; products still in f64).

:func:`inner` and :func:`held_inner` give the readings the f64 inner
products of a Tucker pair with another and with the held tensor, so
that ||A - [G; U]||_F is read without building [G; U].

Imports nothing of the port, of JAX or of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from portbench.reference import quant
from portbench.reference.rsvd_f64 import draw_omega

F64 = torch.float64
CHUNK_ENTRIES = 1 << 26          # a chunk of an unfolding: 512 MiB in f64


@dataclass
class Result:
    core: torch.Tensor               # f64, the effective ranks
    factors: List[torch.Tensor]      # n_i x r_i, f64
    spectra: List[torch.Tensor]      # descending projected-Gram eigenvalues


def order(shape) -> List[int]:
    """Modes in decreasing size, ties in mode order."""
    return sorted(range(len(shape)), key=lambda i: -shape[i])


def effective_ranks(shape, ranks) -> List[int]:
    """``ranks`` clipped as the docstring of ``tucker`` says: at most
    n_i, and at most the product of the other modes as they stand when
    mode i is processed."""
    eff = [int(min(r, n)) for r, n in zip(ranks, shape)]
    cur = list(shape)
    for mode in order(shape):
        rest = math.prod(s for j, s in enumerate(cur) if j != mode)
        eff[mode] = min(eff[mode], rest)
        cur[mode] = eff[mode]
    return eff


def _rounder(numerics: str):
    if numerics == "exact":
        return lambda x: x.to(F64)
    if numerics == "tf32":
        return lambda x: quant.tf32(x.float()).to(F64)
    raise ValueError(f"tensor numerics {numerics!r}")


def _chunks(unf):
    """(column slice, columns) of an unfolding, in chunks."""
    n, rest = unf.shape
    step = max(1, CHUNK_ENTRIES // max(n, 1))
    for c0 in range(0, rest, step):
        sl = slice(c0, min(rest, c0 + step))
        yield sl, unf[:, sl]


def _orth(y):
    """An orthonormal basis of range(y) (Householder)."""
    return torch.linalg.qr(y, mode="reduced")[0]


def _inv_sqrt(g):
    """T with T^T g T = I for a symmetric positive definite g."""
    w, v = torch.linalg.eigh(g)
    return v * torch.rsqrt(torch.clamp(w, min=torch.finfo(F64).tiny))[None, :]


def _mode_step(unf, rank, l, omega, q, rnd, gauge_u):
    """(U n x r, contracted r x rest, descending eigenvalues) of one
    mode's unfolding ``unf`` (any float dtype), read chunk by chunk."""
    n = unf.shape[0]
    dev = unf.device
    y = torch.zeros(n, l, dtype=F64, device=dev)
    for sl, x in _chunks(unf):
        y += rnd(x) @ rnd(omega[sl])
    q_mat = _orth(y)
    for _ in range(q):
        qt = rnd(q_mat)
        gz = torch.zeros(l, l, dtype=F64, device=dev)
        for _, x in _chunks(unf):
            z = rnd(x).T @ qt
            gz += z.T @ z
        t = _inv_sqrt(gz)                       # Z T is orthonormal
        y.zero_()
        for _, x in _chunks(unf):
            xr = rnd(x)
            y += xr @ rnd((xr.T @ qt) @ t)
        q_mat = _orth(y)
    qt = rnd(q_mat)
    gb = torch.zeros(l, l, dtype=F64, device=dev)
    for _, x in _chunks(unf):
        b = rnd(qt.T @ rnd(x))
        gb += b @ b.T
    w, v = torch.linalg.eigh(0.5 * (gb + gb.T))
    w, v = w.flip(0), v.flip(1)
    u = rnd(q_mat) @ rnd(v[:, :rank])
    if gauge_u is not None:
        side = torch.sign(torch.sum(u * gauge_u.to(device=dev, dtype=F64),
                                    dim=0))
        u = u * torch.where(side == 0, torch.ones_like(side), side)[None, :]
    ut = rnd(u)
    out = torch.empty(rank, unf.shape[1], dtype=F64, device=dev)
    for sl, x in _chunks(unf):
        out[:, sl] = ut.T @ rnd(x)
    return u, out, w


def sthosvd(held: torch.Tensor, ranks: Sequence[int], p: int, q: int,
            seed: int, numerics: str = "exact",
            gauge: Optional[Sequence[torch.Tensor]] = None) -> Result:
    """The reference's Tucker of ``held`` (any float dtype, read as it
    is, never copied where its first mode is laid out first) for the
    call's sketch ``seed``."""
    rnd = _rounder(numerics)
    shape = list(held.shape)
    eff = effective_ranks(shape, ranks)
    cur = held
    factors: List[Optional[torch.Tensor]] = [None] * len(shape)
    spectra: List[Optional[torch.Tensor]] = [None] * len(shape)
    for mode in order(held.shape):
        n = shape[mode]
        unf = cur.movedim(mode, 0).reshape(n, -1)
        del cur                                 # a core is freed here
        rest = unf.shape[1]
        l = min(eff[mode] + p, n, rest)
        omega = draw_omega(seed + 7919 * mode, rest, l, held.device)
        u, out, w = _mode_step(unf, eff[mode], l, omega, q, rnd,
                               None if gauge is None else gauge[mode])
        del omega, unf
        factors[mode], spectra[mode] = u, w
        shape[mode] = eff[mode]
        moved = [shape[mode]] + [s for j, s in enumerate(shape) if j != mode]
        cur = out.reshape(moved).movedim(0, mode)
        del out
    return Result(cur.contiguous(), factors, spectra)


def norm_sq(held: torch.Tensor) -> float:
    """||held||_F^2 in f64, read in chunks of its first mode."""
    flat = held.reshape(held.shape[0], -1)
    total = torch.zeros((), dtype=F64, device=held.device)
    for _, x in _chunks(flat):
        total += torch.sum(torch.square(x.to(F64)))
    return float(total)


def inner(core, factors, core_r, factors_r) -> float:
    """<[G; U], [G_r; U_r]> = <G, G_r x_i (U_i^T U_r,i)>, in f64, from
    the cores and the n_i x r_i factors alone."""
    t = core_r.to(F64)
    for i, (u, ur) in enumerate(zip(factors, factors_r)):
        m = u.to(device=ur.device, dtype=F64).T @ ur.to(F64)   # r_i x r_i
        t = torch.movedim(torch.tensordot(m, t, dims=([1], [i])), 0, i)
    return float(torch.sum(core.to(device=t.device, dtype=F64) * t))


def held_inner(held: torch.Tensor, core, factors) -> float:
    """<A, [G; U]> = <A x_i U_i^T, G> in f64: the held tensor read in
    chunks of its first mode, each widened and contracted with the other
    modes' factors (the widest cut first), the n_0 x r_1 x ... result
    then with U_0."""
    dev = held.device
    us = [u.to(device=dev, dtype=F64) for u in factors]
    rest = sorted(range(1, held.dim()),
                  key=lambda i: us[i].shape[1] / held.shape[i])
    n0, step = held.shape[0], max(1, CHUNK_ENTRIES // max(1, held[0].numel()))
    part = torch.empty([n0] + [u.shape[1] for u in us[1:]], dtype=F64,
                       device=dev)
    for r0 in range(0, n0, step):
        t = held[r0:r0 + step].to(F64)
        for i in rest:
            t = torch.movedim(torch.tensordot(t, us[i], dims=([i], [0])),
                              -1, i)
        part[r0:r0 + step] = t
    proj = torch.tensordot(us[0], part, dims=([0], [0]))
    return float(torch.sum(proj * core.to(device=dev, dtype=F64)))
