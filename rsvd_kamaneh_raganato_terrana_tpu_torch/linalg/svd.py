"""Method-dispatched SVD engine (the JAX package's ``linalg/svd.py``).

Engines, as in JAX:

- ``'jacobi'``          -- one-sided tournament Jacobi, column-update
                           rounds (``linalg/jacobi.py``, ``apply='scatter'``);
- ``'parallel_jacobi'`` -- the same sweeps with the crossover of
                           ``jacobi_svd(apply='auto')``: GEMM rounds up to
                           n = 256, scatter up to 512, the block
                           tournament above;
- ``'power'``           -- power iteration with deflation
                           (``linalg/power.py``);
- ``'eigh'``            -- one eigendecomposition of the small-side Gram
                           matrix, ``torch.linalg.eigh``;
- ``'eigh_pallas'``     -- the same Gram route with the eigh by kernel K3
                           (``linalg/kernels.py::eigh_small``);
- ``'xla'``             -- ``torch.linalg.svd``;
- ``'auto'``            -- 'parallel_jacobi' for min(m, n) <= 256, else
                           'xla'.

V holds the right singular vectors as columns for every method.
"""

from __future__ import annotations

import enum

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import matmul_at
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.jacobi import jacobi_svd
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.power import power_svd


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
    """A = U diag(s) V^T, truncated to rank ``r`` if r > 0 (r = 0: the
    full min(m, n) decomposition).  Engine keyword arguments go to the
    Jacobi and Power engines, and are dropped for 'xla' (and so for
    'auto' above its threshold)."""
    method = SVDMethod.parse(method)
    if a.is_complex() and method is not SVDMethod.XLA:
        raise TypeError("the Jacobi/Power/Gram engines are real-only "
                        "(plain transposes throughout); use method='xla' "
                        "for complex input")
    if method is SVDMethod.Auto:
        method = (SVDMethod.ParallelJacobi if min(a.shape) <= 256
                  else SVDMethod.XLA)
    if method is SVDMethod.XLA:
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        v = vh.conj().T
    elif method is SVDMethod.Jacobi:
        u, s, v = jacobi_svd(a, apply="scatter", **kwargs)
    elif method is SVDMethod.ParallelJacobi:
        u, s, v = jacobi_svd(a, apply="auto", **kwargs)
    elif method is SVDMethod.Power:
        res = power_svd(a, k=r if r > 0 else min(a.shape), **kwargs)
        u, s, v = res.u, res.s, res.v
    elif method is SVDMethod.GramEigh:
        u, s, v = _gram_eigh_svd(a)
    else:                                      # GramEighPallas
        u, s, v = _gram_eigh_svd(a, kernels.eigh_small)
    if r > 0:
        u, s, v = u[:, :r], s[:r], v[:, :r]
    return u, s, v


class SVD:
    """Class-style engine with the reference's API: ``SVD(data, r)``,
    ``compute()``, ``getU``/``getS``/``getV``."""

    def __init__(self, data, r: int = 0, method=SVDMethod.Jacobi):
        self._data = data
        self._r = int(r)
        self._method = SVDMethod.parse(method)
        self._u = self._s = self._v = None

    def setData(self, data):  # noqa: N802  (reference name)
        self._data = data
        self._u = self._s = self._v = None
        return self

    def compute(self, **kwargs) -> "SVD":
        self._u, self._s, self._v = svd(self._data, self._method, self._r,
                                        **kwargs)
        return self

    def getU(self):  # noqa: N802
        self._ensure()
        return self._u

    def getS(self):  # noqa: N802
        self._ensure()
        return self._s

    def getV(self):  # noqa: N802
        self._ensure()
        return self._v

    @property
    def rank(self) -> int:
        return self._r

    @property
    def method(self) -> SVDMethod:
        return self._method

    def reconstruction(self):
        self._ensure()
        return matmul_at(self._u * self._s[None, :], self._v.T, "highest")

    def reconstruction_error(self):
        return torch.linalg.norm(self._data - self.reconstruction())

    def _ensure(self):
        if self._u is None:
            self.compute()


def polar(a, side: str = "right", method=SVDMethod.XLA):
    """Polar decomposition A = U_p H (side='right', H SPD on the column
    space) or A = H U_p (side='left'), recombined from the SVD:
    U_p = U V^T, H = V diag(s) V^T (or U diag(s) U^T)."""
    u, s, v = svd(a, method)
    u_p = matmul_at(u, v.T, "highest")
    if side == "right":
        h = matmul_at(v * s[None, :], v.T, "highest")
    elif side == "left":
        h = matmul_at(u * s[None, :], u.T, "highest")
    else:
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    return u_p, h


def procrustes(a, b, method=SVDMethod.XLA):
    """Orthogonal Procrustes: the rotation Q = argmin_{Q^T Q = I}
    ||A Q - B||_F, via the SVD of A^T B."""
    u, _, v = svd(matmul_at(a.T, b, "highest"), method)
    return matmul_at(u, v.T, "highest")
