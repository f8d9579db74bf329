"""Method-dispatched SVD engine (the JAX package's ``linalg/svd.py``).

Ported methods: ``'eigh'`` (one eigendecomposition of the small-side
Gram matrix, ``torch.linalg.eigh``; this is XLA's eigh in the JAX
package, not a Pallas kernel) and ``'xla'`` (``torch.linalg.svd``).
The other engines -- ``jacobi``, ``parallel_jacobi``, ``power``,
``eigh_pallas`` (kernel K3) and ``auto`` -- are not ported yet
(ROADMAP.md) and raise ``NotImplementedError`` rather than switching to
another method silently.
"""

from __future__ import annotations

import enum

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at


class SVDMethod(enum.Enum):
    Jacobi = "jacobi"
    Power = "power"
    ParallelJacobi = "parallel_jacobi"
    GramEigh = "eigh"
    GramEighPallas = "eigh_pallas"
    XLA = "xla"
    Auto = "auto"

    @classmethod
    def parse(cls, value) -> "SVDMethod":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())


PORTED_METHODS = (SVDMethod.GramEigh, SVDMethod.XLA)


def check_ported(method) -> SVDMethod:
    """Parse ``method`` and raise ``NotImplementedError`` if its engine
    is not ported yet."""
    method = SVDMethod.parse(method)
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"SVD method {method.value!r} is not ported to the PyTorch "
            "package yet (ROADMAP.md); use 'eigh' or 'xla'")
    return method


def _gram_eigh_svd(a, eigh_fn=torch.linalg.eigh):
    """SVD via the eigendecomposition of the small-side Gram matrix: one
    eigh and one GEMM.  ``eigh_fn`` follows the ``torch.linalg.eigh``
    contract (ascending eigenvalues, eigenvectors in columns)."""
    m, n = a.shape
    dtype = a.dtype
    if dtype in (torch.bfloat16, torch.float16):
        # no low-precision eigh: factor in f32, return the input dtype
        u, s, v = _gram_eigh_svd(a.to(torch.float32), eigh_fn)
        return u.to(dtype), s.to(dtype), v.to(dtype)
    if m <= n:
        g = matmul_at(a, a.T, "highest")
        lam, u = eigh_fn(g)                    # ascending
        lam = torch.clamp(lam.flip(0), min=0.0)
        u = u.flip(1)
        s = torch.sqrt(lam)
        safe = torch.clamp(s, min=torch.finfo(dtype).tiny)
        v = matmul_at(a.T, u, "highest") / safe[None, :]
        v = torch.where(s[None, :] > 0, v, torch.zeros_like(v))
        return u, s, v
    v, s, u = _gram_eigh_svd(a.T, eigh_fn)
    return u, s, v


def svd(a, method=SVDMethod.Jacobi, r: int = 0, **kwargs):
    """A = U diag(s) V^T, truncated to rank ``r`` if r > 0.  V holds the
    right singular vectors as columns.  Engine keyword arguments have no
    counterpart in the ported methods and are ignored."""
    method = check_ported(method)
    if a.is_complex():
        raise TypeError("the Gram engine is real-only; complex input is "
                        "not supported by the ported methods")
    if method is SVDMethod.XLA:
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        v = vh.T
    else:
        u, s, v = _gram_eigh_svd(a)
    if r > 0:
        u, s, v = u[:, :r], s[:r], v[:, :r]
    return u, s, v
