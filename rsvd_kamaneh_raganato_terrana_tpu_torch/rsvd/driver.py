"""Randomized SVD driver (Halko-Martinsson-Tropp stage A/B), the JAX
package's ``rsvd/driver.py`` for ``finish='project'``:

  stage A:  Y = A Omega  ->  Q = orth(Y)  ->  q rounds of power-iteration
            subspace refinement with re-orthonormalization,
  stage B:  B = Q^T A  ->  small SVD of B  ->  U = Q U_tilde.

The stage-A GEMMs go to ``torch.matmul``/``torch.mm`` at the requested
precision (``core/device.py``); the orthonormalizations go through
``linalg.qr.qr_reduced``, whose ``cholqr1_fused`` method is the
hand-written Hopper kernel K1.

Not ported yet (ROADMAP.md), each raising ``NotImplementedError``: the
finishes ``'rowspace'``, ``'utv'`` and ``'rowspace_utv'``; ``Int8Stored``
operands and ``precision='int8'``; ``'high'``/``'bf16'`` precisions;
sparse operands; ``sketch='fused'`` (kernel K4); the SVD engines other
than ``'eigh'`` and ``'xla'``.
"""

from __future__ import annotations

from typing import Optional

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    matmul_at,
    resolve_precision,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    key_from_seed,
    sketch_matrix,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import (
    orthonormal_basis,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    check_ported,
    svd as small_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)

_UNPORTED_FINISHES = ("rowspace", "utv", "rowspace_utv")
_UNPORTED_QR = ("polar", "polar_fused")


def generate_omega(key_or_seed, n: int, l: int, dtype=torch.float32,
                   kind: str = "gaussian", device=None):
    """The n x l Gaussian test matrix, drawn from a ``torch.Generator``
    seeded from ``key_or_seed`` on ``device`` (or from the generator
    passed in, on its own device)."""
    key = key_from_seed(key_or_seed, device)
    return sketch_matrix(key, n, l, dtype, kind)


def _check_dense(x):
    if x.layout != torch.strided:
        raise NotImplementedError(
            "sparse operands are not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1)")


def _mm(a, b, precision=DOT_PRECISION):
    """A @ B with the JAX driver's dtype rules: same dtype -> product in
    that dtype; a bf16 operand mixed with a wider one -> the SMALL side is
    rounded to bf16 and the product accumulates and returns in the wide
    dtype (never widening the big operand); any other mix promotes."""
    _check_dense(a)
    _check_dense(b)
    if a.dtype != b.dtype:
        lo, out = ((a.dtype, b.dtype) if a.dtype.itemsize < b.dtype.itemsize
                   else (b.dtype, a.dtype))
        if lo == torch.bfloat16:
            return matmul_at(a.to(lo), b.to(lo), precision, out_dtype=out)
        wide = torch.promote_types(a.dtype, b.dtype)
        return matmul_at(a.to(wide), b.to(wide), precision)
    return matmul_at(a, b, precision)


def _colnormalize(y):
    """Diagonal column scaling to unit norms (``interior_qr='none'``)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    norms = torch.sqrt(torch.sum(torch.square(y.to(acc)), dim=0))
    scale = 1.0 / torch.clamp(norms, min=torch.finfo(acc).tiny)
    return y * scale.to(y.dtype)[None, :]


def _interior_basis(y, method: str):
    return _colnormalize(y) if method == "none" else \
        orthonormal_basis(y, method)


def power_refine(a, q_mat, q: int, qr_method: str = "robust",
                 precision=DOT_PRECISION, reorth: str = "full",
                 interior_qr: Optional[str] = None):
    """q rounds of power-iteration subspace refinement.  ``reorth='full'``
    orthonormalizes both the Z and Y sides each round; ``'half'`` skips
    the Z-side QR.  ``interior_qr`` (default: ``qr_method``) is used for
    every orthonormalization except the final one; ``'none'`` only
    column-normalizes."""
    inner = qr_method if interior_qr is None else interior_qr
    for i in range(q):
        last = i == q - 1
        z = _mm(a.T, q_mat, precision)
        if reorth == "full" and inner != "none":
            z = orthonormal_basis(z, inner)
        y = _mm(a, z, precision)
        q_mat = (_interior_basis(y, qr_method) if last
                 else _interior_basis(y, inner))
    return q_mat


def subspace_iteration(a, omega, q: int, qr_method: str = "robust",
                       precision=DOT_PRECISION, reorth: str = "full",
                       interior_qr: Optional[str] = None):
    """Stage A: range finder with q power-iteration refinements."""
    y = _mm(a, omega, precision)
    inner = qr_method if interior_qr is None or q == 0 else interior_qr
    q_mat = _interior_basis(y, inner)
    return power_refine(a, q_mat, q, qr_method, precision, reorth,
                        interior_qr)


def _check_ported(method, qr_method, interior_qr, precision, finish):
    """Refuse unported options before any work is done."""
    check_ported(method)
    resolve_precision(precision)
    for name in (qr_method, interior_qr):
        if name in _UNPORTED_QR:
            raise NotImplementedError(
                f"qr_method={name!r} (Newton-Schulz polar, kernel K2) is "
                "not ported to the PyTorch package yet (ROADMAP.md)")
    if finish in _UNPORTED_FINISHES:
        raise NotImplementedError(
            f"finish={finish!r} is not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1); use 'project'")
    if finish != "project":
        raise ValueError(f"unknown finish {finish!r} (use 'project', "
                         "'rowspace', 'utv' or 'rowspace_utv')")


def rsvd_with_omega(a, omega, q: int = 2, k: int = 0,
                    method: str = "jacobi", qr_method: str = "robust",
                    precision: str = "highest",
                    reorth: str = "full", interior_qr: Optional[str] = None,
                    finish: str = "project"):
    """rSVD given an explicit sketch matrix Omega (n x l).

    ``finish='project'`` (reference semantics): 2q+2 passes over A --
    sketch, q power rounds, projection B = Q^T A -- then the small SVD of
    B by ``method`` and U = Q U_tilde.  Returns (U, s, V) truncated to k
    (all l when k = 0).  The default ``method='jacobi'`` is kept from the
    JAX signature and raises until the Jacobi engine is ported; pass
    ``method='eigh'`` or ``'xla'``."""
    _check_ported(method, qr_method, interior_qr, precision, finish)
    q_mat = subspace_iteration(a, omega, q, qr_method, precision, reorth,
                               interior_qr)                  # m x l
    b = _mm(q_mat.T, a, precision)                          # l x n
    u_t, s, v = small_svd(b, method)
    u = _mm(q_mat, u_t)
    if k > 0:
        u, s, v = u[:, :k], s[:k], v[:, :k]
    return u, s, v


def rsvd_core(a, seed, *, k, p, q, method, sketch, qr_method, precision,
              reorth, interior_qr, finish="project"):
    """Core of :func:`rsvd`: l = k + p (p when k = 0), Omega drawn from
    ``seed`` on A's device, then :func:`rsvd_with_omega`."""
    m, n = a.shape
    l = min(k + p if k > 0 else p, min(m, n))
    if sketch == "fused":
        raise NotImplementedError(
            "sketch='fused' (kernel K4) is not ported to the PyTorch "
            "package yet (ROADMAP.md, queue 2)")
    omega = generate_omega(seed, n, l, a.dtype, sketch, device=a.device)
    return rsvd_with_omega(a, omega, q, k, method, qr_method, precision,
                           reorth, interior_qr, finish)


def rsvd(
    a,
    k: int = 0,
    p: int = 10,
    q: int = 2,
    method=SVDMethod.Jacobi,
    sketch: str = "gaussian",
    qr_method: str = "robust",
    seed: int = 0,
    precision: str = "highest",
    reorth: str = "full",
    interior_qr: Optional[str] = None,
    finish: str = "project",
):
    """Randomized truncated SVD of a dense real tensor: (U, s, V).

    k: target rank (0 = all l = p components); p: oversampling; q: power
    iterations; method: small-SVD engine for the l x n tail; precision:
    'highest' (IEEE fp32 GEMMs) or 'default' (bf16 operands, f32
    accumulation on CUDA).  The default ``method=SVDMethod.Jacobi`` is
    kept from the JAX signature, so a call with it raises
    ``NotImplementedError`` until the Jacobi engine is ported; pass
    ``method='eigh'`` or ``'xla'``."""
    method = SVDMethod.parse(method)
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a)
    if a.is_complex():
        raise TypeError("rsvd supports real dtypes only (the Gram/"
                        "projection chain uses plain transposes)")
    return rsvd_core(a, seed, k=k, p=p, q=q, method=method.value,
                     sketch=sketch, qr_method=qr_method, precision=precision,
                     reorth=reorth, interior_qr=interior_qr, finish=finish)


def reconstruct(u, s, v):
    """A_k = U diag(s) V^T."""
    return _mm(u * s[None, :], v.T)


def reconstruction_error(a, u, s, v):
    """||A - U diag(s) V^T||_F."""
    return torch.linalg.norm(a - reconstruct(u, s, v))
