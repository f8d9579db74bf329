"""A plain f64 ST-HOSVD for the port's Tucker tests, and the readings that
hold a call's core and factors to it.

The semantics of ``rsvd/tucker.py::tucker`` (its docstring), in plain
torch on small tensors, each held whole: for each mode, largest first
(stable), on the current tensor X with its mode unfolding X_(i), l =
min(r_i + p, n_i, rest), Omega the port's documented draw for the mode
(an f32 ``torch.randn`` seeded with ``seed + 7919 i``); Y = X_(i) Omega,
Q = orth(Y); q power rounds Q = orth(X_(i) orth(X_(i)^T Q)); U_i = Q V,
V the top r_i eigenvectors of (Q^T X_(i))(Q^T X_(i))^T; X = U_i^T X_(i)
folded back.  Each step depends on the range of its basis alone, so
Householder QR serves.  ``gauge`` turns each column of U_i to the side
of the same column of the given factor (a flipped sign changes every
later mode's sketch).

``numerics="tf32"`` is the control: the tensor and every panel a product
reads rounded to TF32 (10 explicit mantissa bits), products in f64.

Imports nothing of the port, of the benchmark or of JAX.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def _mode_mul(t, mat, mode):
    """t x_mode mat (mat: n x R contracts t's size-R axis ``mode``)."""
    return (t.movedim(mode, -1) @ mat.T).movedim(-1, mode)


def planted(shape, core_rank, decay, scale, seed):
    """f32: a Gaussian core of multilinear rank ``core_rank`` scaled by
    scale * prod_i exp(-j / decay_i) at index j of mode i, Gaussian
    factors n_i x R_i / sqrt(n_i), plus N(0, 1) noise."""
    gen = torch.Generator().manual_seed(int(seed))
    t = torch.randn(core_rank, generator=gen, dtype=F64) * scale
    for i, (r, tau) in enumerate(zip(core_rank, decay)):
        view = [1] * len(shape)
        view[i] = r
        t = t * torch.exp(-torch.arange(r, dtype=F64) / tau).view(view)
    for i, (n, r) in enumerate(zip(shape, core_rank)):
        t = _mode_mul(t, torch.randn(n, r, generator=gen, dtype=F64)
                      / math.sqrt(n), i)
    return (t + torch.randn(shape, generator=gen, dtype=F64)).float()


def _omega(seed, n, l):
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn((n, l), generator=gen, dtype=torch.float32)


def _tf32(x):
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(
        torch.float32).to(F64)


def _orth(y):
    return torch.linalg.qr(y, mode="reduced")[0]


def sthosvd(a, ranks, p, q, seed, numerics="exact", gauge=None):
    """(core, factors, spectra) in f64: the ST-HOSVD of the module
    docstring for the call's sketch ``seed`` (ranks within the sizes)."""
    rnd = (lambda x: x.to(F64)) if numerics == "exact" else _tf32
    shape = list(a.shape)
    cur = a
    factors, spectra = [None] * len(shape), [None] * len(shape)
    for mode in sorted(range(len(shape)), key=lambda i: -shape[i]):
        n, r = shape[mode], ranks[mode]
        x = rnd(cur.movedim(mode, 0).reshape(n, -1))
        l = min(r + p, n, x.shape[1])
        q_mat = _orth(x @ rnd(_omega(seed + 7919 * mode, x.shape[1], l)))
        for _ in range(q):
            q_mat = _orth(x @ rnd(_orth(x.T @ rnd(q_mat))))
        b = rnd(rnd(q_mat).T @ x)
        w, v = torch.linalg.eigh(b @ b.T)
        u = rnd(q_mat) @ rnd(v.flip(1)[:, :r])
        if gauge is not None:
            side = torch.sign(torch.sum(u * gauge[mode].to(F64), dim=0))
            u = u * torch.where(side == 0, torch.ones_like(side), side)
        factors[mode], spectra[mode] = u, w.flip(0)
        shape[mode] = r
        moved = [r] + [s for j, s in enumerate(shape) if j != mode]
        cur = (rnd(u).T @ x).reshape(moved).movedim(0, mode)
    return cur, factors, spectra


def _lead_cut(s, k):
    """The k0 in [k/2, k] with the widest relative gap (s_k0 - s_k0+1) /
    s_k0 in the reference's values."""
    lo = max(1, k // 2)
    return lo + int(torch.argmax((s[lo - 1:k] - s[lo:k + 1]) / s[lo - 1:k]))


def readings(a, core, factors, ref):
    """A call's (core, factors) against the reference's: ``err_gap`` (the
    error that ||G|| implies), ``fit_gap`` (the true error ||A - [G; U]||
    of core and factors together), ``orth_gap`` (the factors' largest
    ||U^T U - I||_F / sqrt(r)) and ``lead_gap`` (the worst mode's leading
    k0 projector distance over sqrt(k0))."""
    a64 = a.to(F64)
    a_sq = float(torch.sum(a64 * a64))
    core_r, factors_r, spectra = ref
    eps_r = math.sqrt(a_sq - float(torch.sum(core_r * core_r))) / math.sqrt(a_sq)
    g = core.to(F64)
    eps = math.sqrt(max(a_sq - float(torch.sum(g * g)), 0.0) / a_sq)
    recon = g
    for i, u in enumerate(factors):
        recon = _mode_mul(recon, u.to(F64), i)
    eps_t = float(torch.linalg.norm(a64 - recon)) / math.sqrt(a_sq)
    orth = lead = 0.0
    for u, ur, w in zip(factors, factors_r, spectra):
        u, r = u.to(F64), ur.shape[1]
        orth = max(orth, float(torch.linalg.norm(u.T @ u - torch.eye(r,
                                                                     dtype=F64)))
                   / math.sqrt(r))
        s = torch.sqrt(torch.clamp(w, min=0.0))
        k0 = _lead_cut(s, r) if r < s.numel() else r
        pu, pr = u[:, :k0], ur[:, :k0]
        sq = (torch.sum((pu.T @ pu) ** 2) + k0
              - 2.0 * torch.sum((pu.T @ pr) ** 2))
        lead = max(lead, math.sqrt(max(float(sq), 0.0) / k0))
    return dict(err_gap=abs(eps - eps_r) / eps_r,
                fit_gap=abs(eps_t - eps_r) / eps_r, orth_gap=orth,
                lead_gap=lead)
