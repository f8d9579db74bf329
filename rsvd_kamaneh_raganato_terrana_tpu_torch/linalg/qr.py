"""Thin/full QR factorization (the JAX package's ``linalg/qr.py``).

CholeskyQR family: Gram matrix -> Cholesky -> triangular inverse applied
as one GEMM, once (``cholqr1``), twice (``cholqr2``) or three times
(``cholqr3``), with a shifted retry and a Householder fallback in the
``robust`` variants.  Every Gram and apply product runs at full fp32
(``ops.primitives.DOT_PRECISION``).

Two differences from JAX are forced by PyTorch:

- ``torch.linalg.cholesky`` raises on an indefinite matrix where XLA
  returns NaN, and ``torch.linalg.cholesky_ex`` returns a FINITE partial
  factor with ``info > 0``.  A failed factorization is therefore detected
  by ``info`` (and non-finite entries), never by ``isfinite`` alone --
  otherwise the shifted and Householder fallbacks would never fire.
- JAX's ``lax.cond`` fallback becomes a host-side branch on the
  degradation flag (one device sync) in ``robust``/``robust1`` only; the
  ``cholqr*`` serving chain stays sync-free.
"""

from __future__ import annotations

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.polar import polar_qr
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    gram,
    matmul,
)


def _gram(a):
    return gram(a)


def _chol_maybe_shifted(g, n_rows: int):
    """Cholesky of G with an automatic shifted retry: (C lower, degraded).

    The plain, shifted (s = 11 (m l + l (l+1)) eps ||G||, Fukaya et al.
    2020) and last-resort (diagonal + ||G|| + 1, always SPD) Grams are
    factored in one batched call.  Failure is read from ``info``."""
    l = g.shape[-1]
    eps = torch.finfo(g.dtype).eps
    norm_g = torch.linalg.norm(g)
    shift = 11.0 * (n_rows * l + l * (l + 1)) * eps * norm_g
    eye = torch.eye(l, dtype=g.dtype, device=g.device)
    stacked = torch.stack([g, g + shift * eye, g + (norm_g + 1.0) * eye])
    chol, info = torch.linalg.cholesky_ex(stacked)
    failed = (info != 0) | ~torch.isfinite(chol).flatten(1).all(dim=1)
    c_plain, c_shift, c_last = chol
    bad, bad2 = failed[0], failed[1]
    # near-singular (not only failing) Grams also degrade CholeskyQR2:
    # flag when (min/max diag)^2 falls under ~100 eps
    diag = torch.diagonal(c_plain).abs()
    min_d, max_d = diag.min(), diag.max()
    tiny_diag = ~(min_d * min_d > 100.0 * eps * max_d * max_d)
    c = torch.where(bad, torch.where(bad2, c_last, c_shift), c_plain)
    return c, bad | bad2 | tiny_diag


def _solve_right_upper(a, r):
    """A @ R^{-1} for upper-triangular R: invert the small l x l factor
    with one triangular solve, then apply it as one GEMM."""
    l = r.shape[-1]
    eye = torch.eye(l, dtype=r.dtype, device=r.device)
    r_inv = torch.linalg.solve_triangular(r, eye, upper=True)
    return matmul(a, r_inv)


def _cholesky_qr_flagged(a):
    g = _gram(a)
    c, degraded = _chol_maybe_shifted(g, a.shape[0])
    r = c.T
    q = _solve_right_upper(a, r)
    return q, r, degraded


def cholesky_qr(a):
    """Single-pass CholeskyQR: Q = A R^{-1}, R = chol(A^T A)^T."""
    q, r, _ = _cholesky_qr_flagged(a)
    return q, r


def cholesky_qr1(a):
    """PURE single-pass CholeskyQR: one Gram, one plain Cholesky, one
    triangular-inverse GEMM; no retry, no fallback.  On rank-deficient
    input it returns NaNs, like XLA's Cholesky (the failed factor from
    ``cholesky_ex`` is replaced by NaN, with no host sync)."""
    c, info = torch.linalg.cholesky_ex(_gram(a))
    c = torch.where(info == 0, c, torch.full_like(c, float("nan")))
    r = c.T
    return _solve_right_upper(a, r), r


def cholesky_qr2(a):
    """CholeskyQR2 -- orthogonality error O(eps) for cond(A) < ~1/sqrt(eps)."""
    q, r = robust_cholesky_qr2(a)[:2]
    return q, r


def robust_cholesky_qr2(a):
    """(Q, R, degraded): CholeskyQR2 plus the flag marking inputs where a
    Householder fallback is required for full accuracy."""
    q1, r1, d1 = _cholesky_qr_flagged(a)
    q2, r2, d2 = _cholesky_qr_flagged(q1)
    return q2, matmul(r2, r1), d1 | d2


def cholesky_qr3(a):
    """Three-pass variant for ill-conditioned (but full-rank) inputs."""
    q1, r1, _ = _cholesky_qr_flagged(a)
    q2, r2 = cholesky_qr2(q1)
    return q2, matmul(r2, r1)


def _householder(a):
    q, r = torch.linalg.qr(a, mode="reduced")
    return q, r


def qr_reduced(a, method: str = "robust"):
    """Reduced QR: Q (m x n), R (n x n) for m >= n.

    ``method``: ``robust`` (CholeskyQR2, Householder when degraded),
    ``robust1`` (single-pass, same fallback), ``cholqr1`` / ``cholqr2`` /
    ``cholqr3`` (pure CholeskyQR, no fallback), ``cholqr1_fused``
    (``cholqr1`` as the hand-written Hopper kernel of
    ``linalg/kernels.py::fused_cholqr1``; its plain PyTorch version on
    the CPU) and ``householder``.

    ``polar`` is the GEMM-only Newton--Schulz polar factorization of
    ``linalg/polar.py`` (R symmetric, NOT triangular; rank deficiency out
    of domain), and ``polar_fused`` the same as the hand-written Hopper
    kernel K2 (``linalg/kernels.py::polar_qr_fused``; its plain PyTorch
    version on the CPU).

    ``cholqr1_fused`` and ``polar_fused`` keep the JAX dtype guard -- f32
    panels go to the kernel, other dtypes to ``cholesky_qr1`` /
    ``polar_qr`` -- but not the JAX size guard: that bound (m x 128 x
    8 B <= 12 MiB) is the TPU's VMEM, and the Hopper kernels stream Y
    from device memory, so every f32 panel goes through the kernel
    whatever its size.
    """
    if a.dtype in (torch.bfloat16, torch.float16):
        # no low-precision Cholesky/QR: factor in f32, hand back the
        # input dtype
        q, r = qr_reduced(a.to(torch.float32), method)
        return q.to(a.dtype), r.to(a.dtype)
    if method == "robust":
        q, r, degraded = robust_cholesky_qr2(a)
        return _householder(a) if bool(degraded) else (q, r)
    if method == "robust1":
        q, r, degraded = _cholesky_qr_flagged(a)
        return _householder(a) if bool(degraded) else (q, r)
    if method == "cholqr1":
        return cholesky_qr1(a)
    if method == "cholqr1_fused":
        if a.dtype == torch.float32:
            return kernels.fused_cholqr1(a)
        return cholesky_qr1(a)
    if method == "polar":
        return polar_qr(a)
    if method == "polar_fused":
        if a.dtype == torch.float32:
            return kernels.polar_qr_fused(a)
        return polar_qr(a)
    if method == "cholqr2":
        return cholesky_qr2(a)
    if method == "cholqr3":
        return cholesky_qr3(a)
    if method == "householder":
        return _householder(a)
    raise ValueError(f"unknown QR method {method!r}")


def qr_full(a):
    """Full QR: Q (m x m), R (m x n)."""
    return torch.linalg.qr(a, mode="complete")


def orthonormal_basis(y, method: str = "robust"):
    """Thin orthonormal basis of range(Y)."""
    q, _ = qr_reduced(y, method)
    return q
