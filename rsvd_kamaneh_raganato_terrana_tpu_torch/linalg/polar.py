"""GEMM-only orthonormalization by Newton--Schulz polar iteration (the
JAX package's ``linalg/polar.py``).

    Q = Y (G/alpha)^{-1/2} / sqrt(alpha),    G = Y^T Y,

with alpha the row-sum (inf) norm of G and (G/alpha)^{-1/2} reached by a
per-iteration near-minimax degree-2 polynomial schedule
(:func:`ns_schedule`): W <- W p_k(H), H = W^T G~ W recomputed every
iteration.  range(Q) = range(Y) exactly for any invertible iterate.

Contracts, as in JAX (serving-mode, like ``cholqr1``): Q orthonormal to
~sqrt(l) eps cond-ish in f32; R = W_s G symmetric, NOT triangular, with
Y ~ Q R; rank deficiency is out of domain (NaN or garbage, flagged by
``rsvd.diagnostics.factor_health``).  Every product is full fp32 (no
TF32, no bf16): the schedule diverges at single-pass bf16 noise.

``ns_schedule`` is a NumPy copy of the JAX function (the JAX module
imports jax at its top, so it cannot be imported here); its output is
bitwise equal to JAX's.  The fused form, the hand-written Hopper kernel
K2, is ``linalg/kernels.py::polar_qr_fused``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    gram,
    matmul,
)


@lru_cache(maxsize=None)
def ns_schedule(iters: int = 8, mu_min: float = 1e-6,
                hi_margin: float = 0.01):
    """Per-iteration degree-2 coefficients ((a, b, c), ...) plus the
    final guaranteed eigenvalue interval lower bound.

    Each iteration fits p(mu) = a + b mu + c mu^2 to mu^{-1/2} on the
    current [lo, 1 + hi_margin] in the relative minimax sense (Lawson's
    iteratively reweighted least squares), then rescales so the mapped
    interval's upper edge returns to exactly 1.  ``hi_margin`` is the
    overshoot safety band that lets the map contract eigenvalues that
    matmul noise lifts above 1; it sets a ~4e-8 orthogonality floor.
    Pure NumPy, cached."""
    lo, hi = float(mu_min), 1.0 + float(hi_margin)
    coeffs = []
    for _ in range(iters):
        mu = np.geomspace(lo, hi, 4096)
        # minimize max |p(mu) sqrt(mu) - 1|  (relative error of p vs
        # mu^{-1/2}): Lawson re-weighting drives LSQ toward minimax
        basis = np.stack([np.ones_like(mu), mu, mu * mu], axis=1)
        design = basis * np.sqrt(mu)[:, None]
        w = np.full(mu.shape, 1.0 / mu.size)
        sol = None
        for _ in range(80):
            sw = np.sqrt(w)[:, None]
            sol, *_ = np.linalg.lstsq(design * sw, np.sqrt(w), rcond=None)
            err = np.abs(design @ sol - 1.0)
            w = w * (err + 1e-14)
            w /= w.sum()
        g = mu * (basis @ sol) ** 2
        g_hi = float(g.max())
        g_lo = float(g.min())
        if not (g_lo > 0.0):          # pragma: no cover - schedule guard
            raise RuntimeError("ns_schedule: non-positive map (mu_min "
                               f"{mu_min} too small for degree-2 fit)")
        # renormalize so the mapped top edge lands at 1
        s = 1.0 / np.sqrt(g_hi)
        coeffs.append((float(sol[0] * s), float(sol[1] * s),
                       float(sol[2] * s)))
        lo, hi = g_lo / g_hi, 1.0 + float(hi_margin)
    return tuple(coeffs), lo


def _ns_inverse_sqrt(g, iters: int, mu_min: float):
    """(W_s, alpha): W_s ~ G^{-1/2} via the scheduled iteration; every op
    is an l x l product or an elementwise op.  alpha is the row-sum norm
    of G (a lambda_max bound), with no diagonal shift: eigenvalues that
    roundoff pushes negative (rank-deficient input) explode, the same
    out-of-domain behaviour as cholqr1's NaNs."""
    coeffs, _ = ns_schedule(iters, mu_min)
    l = g.shape[-1]
    eye = torch.eye(l, dtype=g.dtype, device=g.device)
    alpha = torch.max(torch.sum(torch.abs(g), dim=1)) \
        + torch.finfo(g.dtype).tiny
    gt = g / alpha

    def actual_h(w):
        # H = W^T G~ W, the true Gram of the implicit iterate Y W
        h = matmul(w.T, matmul(gt, w))
        return 0.5 * (h + h.T)

    a0, b0, c0 = coeffs[0]
    h2 = matmul(gt, gt)
    w = a0 * eye + b0 * gt + c0 * h2          # W_1 = p_1(G~)
    h = actual_h(w)
    for a, b, c in coeffs[1:]:
        h2 = matmul(h, h)
        p = a * eye + b * h + c * h2
        w = matmul(w, p)
        h = actual_h(w)
    return w * torch.rsqrt(alpha), alpha


def polar_orthonormalize(y, iters: int = 8, mu_min: float = 1e-6):
    """Orthonormal basis of range(Y) by GEMM-only Newton--Schulz."""
    w_s, _ = _ns_inverse_sqrt(gram(y), iters, mu_min)
    return matmul(y, w_s)


def polar_qr(y, iters: int = 8, mu_min: float = 1e-6):
    """(Q, R) with Q orthonormal, R = Q^T Y symmetric PSD (NOT
    triangular) and Y ~ Q R."""
    g = gram(y)
    w_s, _ = _ns_inverse_sqrt(g, iters, mu_min)
    return matmul(y, w_s), matmul(w_s, g)      # R without a tall GEMM
