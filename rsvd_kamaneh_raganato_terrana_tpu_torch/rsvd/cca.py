"""Randomized canonical correlation analysis (the JAX package's
``rsvd/cca.py``): the top-k canonical correlations and directions
between two views X (n x p) and Y (n x q),

    max corr(X a, Y b)  s.t. successive pairs uncorrelated,

from the SVD of the whitened cross-covariance C_xx^{-1/2} C_xy
C_yy^{-1/2} (Hotelling).  Three GEMMs form the covariances; whitening
uses ridge-regularized Cholesky factors (``core/device.py::cholesky``,
NaN where a factor fails, as in XLA) and triangular solves; the
truncated SVD of the whitened p x q matrix runs through the rSVD driver
when min(p, q) > 256 (Omega from the driver's ``generate_omega``) and
exactly (``torch.linalg.svd``, NaN for a NaN input as in XLA:
``core/device.py::svd_nan``) otherwise.

The two views may be DTensors whose rows (the samples) are sharded over
one mesh: the column means are merged over the ranks, the three
covariances are the local products all-reduced, and everything after
them is replicated, as on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    cholesky,
    matmul_at,
    svd_nan,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd import driver
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _mean,
    _reduce,
    _row_block,
    _row_split,
)


class CcaResult(NamedTuple):
    correlations: torch.Tensor   # k canonical correlations, descending in [0, 1]
    x_weights: torch.Tensor      # p x k (apply to centered X)
    y_weights: torch.Tensor      # q x k
    x_mean: torch.Tensor         # p
    y_mean: torch.Tensor         # q


def _whitener(c, reg: float):
    """Lower Cholesky factor of C + reg tr(C)/d I."""
    r = reg * torch.trace(c) / c.shape[0]
    return cholesky(c + r * torch.eye(c.shape[0], dtype=c.dtype,
                                      device=c.device))


def _cov(x, y):
    """X^T Y of two tensors, or of two panels split by the same rows (the
    local products all-reduced)."""
    return _reduce(matmul_at(_local(x).T, _local(y), DOT_PRECISION), x)


def _cca_impl(x, y, k: int, reg: float, seed: int, use_rsvd: bool):
    n = x.shape[0]
    xm = _mean(x)
    ym = _mean(y)
    xc = _like(x, _local(x) - xm)
    yc = _like(y, _local(y) - ym)
    denom = float(n - 1)
    cxx = _cov(xc, xc) / denom
    cyy = _cov(yc, yc) / denom
    cxy = _cov(xc, yc) / denom
    lx = _whitener(cxx, reg)
    ly = _whitener(cyy, reg)
    # M = Lx^{-1} Cxy Ly^{-T}
    m = torch.linalg.solve_triangular(lx, cxy, upper=False)
    m = torch.linalg.solve_triangular(ly, m.T, upper=False).T
    if use_rsvd:
        omega = driver.generate_omega(seed, m.shape[1],
                                      min(k + 10, min(m.shape)), m.dtype,
                                      device=m.device)
        u, s, v = driver.rsvd_with_omega(m, omega, q=2, k=k, method="eigh")
    else:
        u, s, vh = svd_nan(m)
        u, s, v = u[:, :k], s[:k], vh.T[:, :k]
    # back-transform: a = Lx^{-T} u, b = Ly^{-T} v
    a = torch.linalg.solve_triangular(lx.T, u, upper=True)
    b = torch.linalg.solve_triangular(ly.T, v, upper=True)
    return torch.clamp(s, 0.0, 1.0), a, b, xm, ym


def cca(x, y, k: int = 2, reg: float = 1e-6, seed: int = 0) -> CcaResult:
    """Top-k canonical correlations and directions between views X
    (n x p) and Y (n x q).  ``reg`` is the relative ridge on each view's
    covariance.  The rSVD driver factors the whitened cross-covariance
    when min(p, q) > 256, the exact SVD otherwise.  Project new data with
    ``(x_new - res.x_mean) @ res.x_weights``.  Tensors stay on their
    device (Y goes to X's); any other array goes to the card.  Views
    whose rows are sharded (DTensors over one mesh; a whole Y beside a
    sharded X is read by X's rows) give replicated results (the module
    docstring)."""
    x = _row_split(x)
    y = _row_split(y) if isinstance(x, Sharded) else as_tensor(
        y, device=x.device)
    if isinstance(x, Sharded) and not isinstance(y, Sharded):
        if y.shape[0] != x.shape[0]:
            raise ValueError("views must have the same number of rows")
        y = x.with_local(_row_block(x, y.to(x.device)))
    if x.shape[0] != y.shape[0]:
        raise ValueError("views must have the same number of rows")
    k = min(k, x.shape[1], y.shape[1])
    use_rsvd = min(x.shape[1], y.shape[1]) > 256
    return CcaResult(*_cca_impl(x, y, k, reg, seed, use_rsvd))
