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
                           matrix: torch's eigh (NaN out for a non-finite
                           Gram, as XLA's, where torch's raises:
                           ``core/device.py::eigh_nan``), in f32 with one
                           Newton--Schulz step (``core/device.py::eigh``)
                           so that the eigenvectors are orthogonal to
                           working precision, as ``jnp.linalg.eigh``'s are;
- ``'eigh_pallas'``     -- the same Gram route with the eigh by kernel K3
                           (``linalg/kernels.py::eigh_small``);
- ``'xla'``             -- ``torch.linalg.svd`` (NaN out for a
                           non-finite input, as XLA's:
                           ``core/device.py::svd_nan``);
- ``'auto'``            -- 'parallel_jacobi' for min(m, n) <= 256, else
                           'xla'.

V holds the right singular vectors as columns for every method.
"""

from __future__ import annotations

import enum

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    eigh,
    eigh_nan,
    matmul_at,
    svd_nan,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    row_sharded_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import span
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg import kernels
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.jacobi import jacobi_svd
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.power import power_svd
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.qr import qr_reduced


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


def _gram_eigh_svd(a, eigh_fn=None):
    """SVD via the eigendecomposition of the small-side Gram matrix: one
    eigh and one GEMM.  ``eigh_fn`` follows the ``torch.linalg.eigh``
    contract (ascending eigenvalues, eigenvectors in columns).  By
    default an f32 Gram goes to ``core/device.py::eigh``: cuSOLVER's f32
    eigenvectors left ||U^T U - I||_F at 1.5e-4 on the main path's
    80 x 80 Gram, and its Newton--Schulz step brings them to 1.4e-6, the
    level of Q itself (H100, PERF.md), as ``jnp.linalg.eigh``'s are.  A
    wider Gram's eigenvectors already are orthogonal to working
    precision, and it goes to ``eigh_nan`` as it comes: there the step
    would only re-round the eigenvectors of the eigenvalues at roundoff,
    which V = A^T U / s then amplifies."""
    m, n = a.shape
    dtype = a.dtype
    if eigh_fn is None:
        eigh_fn = eigh if dtype in (torch.float32, torch.bfloat16,
                                    torch.float16) else eigh_nan
    if dtype in (torch.bfloat16, torch.float16):
        # no low-precision eigh: factor in f32, return the input dtype
        u, s, v = _gram_eigh_svd(a.to(torch.float32), eigh_fn)
        return u.to(dtype), s.to(dtype), v.to(dtype)
    split = isinstance(a, Sharded)
    if (m <= n and not split) or (split and a.transposed):
        # a = C^T where split, C's rows split
        at = a.T.local if split else a.T
        g = a.T.gram() if split else matmul_at(a, a.T, "highest")
        lam, u = eigh_fn(g)                    # ascending
        lam = torch.clamp(lam.flip(0), min=0.0)
        u = u.flip(1)
        s = torch.sqrt(lam)
        safe = torch.clamp(s, min=torch.finfo(dtype).tiny)
        v = matmul_at(at, u, "highest") / safe[None, :]
        v = torch.where(s[None, :] > 0, v, torch.zeros_like(v))
        return u, s, (a.T.with_local(v) if split else v)
    v, s, u = _gram_eigh_svd(a.T, eigh_fn)
    return u, s, v


@row_sharded_api
def svd(a, method=SVDMethod.Jacobi, r: int = 0, **kwargs):
    """A = U diag(s) V^T, truncated to rank ``r`` if r > 0 (r = 0: the
    full min(m, n) decomposition).  Engine keyword arguments go to the
    Jacobi and Power engines, and are dropped for 'xla' (and so for
    'auto' above its threshold).

    ``a`` may be the transpose of a row-split panel (``.T`` of a
    ``core/distributed.py::Sharded``, the rowspace finish's C^T): the
    Gram engines run on its all-reduced Gram, V stays row-split; every
    other engine runs on the gathered panel, each rank keeping its rows
    of V.  ``a`` may also be a tall row-split matrix (PCA's centred data):
    the Gram engines run on its Gram, the Jacobi engines on the R factor
    of its row-split thin QR (their own preconditioning), and 'power',
    'xla' and 'auto' on that R factor too; U stays row-split.  At the
    API such a matrix is a DTensor whose rows are sharded, and U comes
    back row-sharded.  Runs under the span ``rsvd/tail``
    (``core/profiling.py``)."""
    with span("tail"):
        return _svd(a, SVDMethod.parse(method), r, **kwargs)


def _svd(a, method: SVDMethod, r: int, **kwargs):
    if isinstance(a, Sharded):
        return _svd_split(a, method, r, **kwargs)
    if a.is_complex() and method is not SVDMethod.XLA:
        raise TypeError("the Jacobi/Power/Gram engines are real-only "
                        "(plain transposes throughout); use method='xla' "
                        "for complex input")
    if method is SVDMethod.Auto:
        method = (SVDMethod.ParallelJacobi if min(a.shape) <= 256
                  else SVDMethod.XLA)
    if method is SVDMethod.XLA:
        u, s, vh = svd_nan(a)
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


def _svd_split(a, method: SVDMethod, r: int, **kwargs):
    if not a.transposed and a.shape[0] < a.shape[1]:
        raise ValueError("a row-split matrix is factored tall (m >= n) "
                         "or as the transpose of a row split")
    if method is SVDMethod.Auto:
        method = (SVDMethod.ParallelJacobi if min(a.shape) <= 256
                  else SVDMethod.XLA)
    if method is SVDMethod.GramEigh:
        u, s, v = _gram_eigh_svd(a)
    elif method is SVDMethod.GramEighPallas:
        u, s, v = _gram_eigh_svd(a, kernels.eigh_small)
    elif not a.transposed and method is SVDMethod.Jacobi:
        u, s, v = jacobi_svd(a, apply="scatter", **kwargs)
    elif not a.transposed and method is SVDMethod.ParallelJacobi:
        u, s, v = jacobi_svd(a, apply="auto", **kwargs)
    elif not a.transposed:
        # a tall row-split matrix: the engine factors R of A = Q R
        q0, r0 = qr_reduced(a, "robust")
        ur, s, v = svd(r0, method, r, **kwargs)
        u = q0.with_local(matmul_at(q0.local, ur, "highest"))
    else:
        u, s, v = svd(a.T.gather().T, method, **kwargs)
        v = a.T.keep_rows(v)
    if r > 0:
        u, s, v = _first(u, r), s[:r], _first(v, r)
    return u, s, v


def _first(x, r: int):
    """The first r columns of a tensor or of a row-split panel."""
    return x.with_local(x.local[:, :r]) if isinstance(x, Sharded) \
        else x[:, :r]


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
