"""Proper Orthogonal Decomposition (the JAX package's ``apps/pod.py``).

The reference POD class (POD/ParametricDiffusion1D/src/POD.cpp:1-800)
selects four algorithms by constructor overloads; here they are factory
functions, all returning modes W and singular values sigma:

- ``naive_pod``    -- SVD directly on the snapshot matrix (POD.cpp:116-133).
- ``standard_pod`` -- Quarteroni Alg. 6.1: eigenproblem on C = S^T S when
  ns <= Nh else K = S S^T, modes W_i = S V_i / sigma_i, energy-criterion
  truncation (POD.cpp:153-220).
- ``energy_pod``   -- Alg. 6.2: energy inner product X_h; C~ = S^T X_h S via
  X_h^(1/2) (POD.cpp:272-304).
- ``weight_pod``   -- Alg. 6.3: adds quadrature weights D; S~ = S D^(1/2)
  (POD.cpp:356-434).
- ``incremental_pod`` -- streaming, by Brand column appends
  (``linalg/incremental.py``).

``perform_svd`` keeps the reference's svd_type 0-5 dispatch
(POD.cpp:42-114): 0/1/2 full SVD {Power, Jacobi, ParallelJacobi},
3/4/5 rSVD with the same tail engines.  Symmetric square roots come from
``core/device.py::eigh``; every product runs at full precision.  The
snapshots stay on their device (a tensor's own; any other array goes to
the card).  ``_energy_truncate`` reads sigma on the host: one sync a POD.

``perform_svd``, ``naive_pod`` and ``standard_pod`` take snapshots
sharded by nodes (a DTensor whose rows are sharded): the modes come back
row-sharded, sigma replicated.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import device as _device
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import (
    as_tensor,
    to_numpy,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.incremental import (
    IncrementalSVD,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.svd import (
    SVDMethod,
    svd as full_svd,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
    matmul as _mm,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _cols,
    _like,
    _local,
    _row_split,
    _sharded_view,
    _t_mm_split,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import rsvd

_SVD_TYPE_METHOD = {
    0: SVDMethod.Power,
    1: SVDMethod.Jacobi,
    2: SVDMethod.ParallelJacobi,
    3: SVDMethod.Power,
    4: SVDMethod.Jacobi,
    5: SVDMethod.ParallelJacobi,
}


def perform_svd(a, svd_type: int, rank: int = 0):
    """Reference perform_SVD dispatch (POD.cpp:42-114)."""
    method = _SVD_TYPE_METHOD[int(svd_type)]
    if svd_type >= 3:
        return rsvd(a, k=rank, method=method)
    return full_svd(a, method, rank)


def _energy_truncate(sigma, tol: float, max_rank: int) -> int:
    """Smallest N with relative retained energy >= 1 - tol^2, capped at
    max_rank (reference POD.cpp:206-220)."""
    s2 = to_numpy(sigma).astype(np.float64) ** 2
    total = s2.sum()
    if total == 0:
        return 1
    cum = np.cumsum(s2) / total
    n = int(np.searchsorted(cum, 1.0 - tol * tol) + 1)
    return max(1, min(n, max_rank, len(s2)))


@dataclass
class POD:
    """POD result: modes W (Nh x N), singular values, retained rank."""

    modes: torch.Tensor
    sigma: torch.Tensor
    rank: int
    algorithm: str

    @property
    def W(self):  # noqa: N802  (reference accessor name)
        return self.modes[:, : self.rank]

    def project(self, x):
        """Reduced coordinates W^T x."""
        return _mm(self.W.T, x)

    def expand(self, xr):
        """Back to FOM space W xr."""
        return _mm(self.W, xr)


def _modes_from_gram(s, v, lam):
    """(W, sigma) of the ns x ns Gram route: sigma = sqrt(lambda),
    W = S V / sigma with null columns where sigma = 0."""
    sig = torch.sqrt(torch.clamp(lam, min=0.0))
    safe = torch.clamp(sig, min=torch.finfo(s.dtype).tiny)
    w = _mm(s, v) / safe[None, :]
    return torch.where(sig[None, :] > 0, w, torch.zeros_like(w)), sig


def naive_pod(s, rank: int, svd_type: int = 1, tol: float = 0.0) -> POD:
    """SVD of S directly (reference naive_POD, POD.cpp:116-133).  Snapshots
    sharded by nodes (a DTensor whose rows are sharded) go through the
    sharded ``svd`` or ``rsvd``; the modes come back row-sharded."""
    s = _row_split(s)
    u, sig, _ = perform_svd(s, svd_type, rank if svd_type >= 3 else 0)
    u = _sharded_view(u)
    r = min(rank, u.shape[1])
    if tol > 0:
        r = min(r, _energy_truncate(sig, tol, rank))
    return POD(_to_api(_cols(u, slice(None, rank))), sig[:rank], r, "naive")


def standard_pod(s, rank: int, tol: float = 1e-12, svd_type: int = 1) -> POD:
    """Quarteroni Alg. 6.1 (reference standard_POD, POD.cpp:153-220).
    Snapshots sharded by nodes take the ns x ns route: C = S^T S from the
    all-reduced local products, its SVD replicated, W = S V / sigma on
    each rank's rows (row-sharded); the nh x nh route (ns > nh) would
    need every rank's S and refuses them."""
    s = _row_split(s)
    nh, ns = s.shape
    if isinstance(s, Sharded) and ns > nh:
        raise ValueError("standard_pod of snapshots sharded by nodes takes "
                         f"ns <= nh (got {ns} > {nh}): the nh x nh route "
                         "reads every rank's snapshots")
    if ns <= nh:
        c = (_t_mm_split(s, s, DOT_PRECISION) if isinstance(s, Sharded)
             else _mm(s.T, s))                            # ns x ns
        v, lam, _ = perform_svd(c, svd_type, rank if svd_type >= 3 else 0)
        w, sig = _modes_from_gram(_local(s), v, lam)
        w = _to_api(_like(s, w))
    else:
        k = _mm(s, s.T)                                   # nh x nh
        w, lam, _ = perform_svd(k, svd_type, rank if svd_type >= 3 else 0)
        sig = torch.sqrt(torch.clamp(lam, min=0.0))
    r = _energy_truncate(sig, tol, rank)
    keep = min(rank, w.shape[1])
    return POD(_to_api(_cols(_sharded_view(w), slice(None, keep))),
               sig[:keep], r, "standard")


def _spd_sqrt(xh):
    """X_h^(1/2) and X_h^(-1/2) via eigh (the reference used Eigen
    SelfAdjointEigenSolver::operatorSqrt, POD.cpp:272-279)."""
    lam, q = _device.eigh(xh)
    lam = torch.clamp(lam, min=0.0)
    root = torch.sqrt(lam)
    inv_root = torch.where(
        root > 0, 1.0 / torch.clamp(root, min=torch.finfo(xh.dtype).tiny),
        torch.zeros_like(root))
    return _mm(q * root[None, :], q.T), _mm(q * inv_root[None, :], q.T)


def energy_pod(s, xh, rank: int, tol: float = 1e-12, svd_type: int = 1) -> POD:
    """Quarteroni Alg. 6.2 with energy matrix X_h (reference energy_POD,
    POD.cpp:240-330)."""
    s = as_tensor(s)
    xh = as_tensor(xh, s.device, s.dtype)
    nh, ns = s.shape
    xh_half, xh_inv_half = _spd_sqrt(xh)
    if ns <= nh:
        # C~ = S^T X_h S  (ns x ns)
        c = _mm(s.T, _mm(xh, s))
        v, lam, _ = perform_svd(c, svd_type, rank if svd_type >= 3 else 0)
        w, sig = _modes_from_gram(s, v, lam)
    else:
        # K~ = X_h^(1/2) S S^T X_h^(1/2)  (nh x nh)
        shat = _mm(xh_half, s)
        k = _mm(shat, shat.T)
        u, lam, _ = perform_svd(k, svd_type, rank if svd_type >= 3 else 0)
        sig = torch.sqrt(torch.clamp(lam, min=0.0))
        # back-solve X_h^(1/2) W = U (reference CG loop, POD.cpp:296-304)
        w = _mm(xh_inv_half, u)
    r = _energy_truncate(sig, tol, rank)
    keep = min(rank, w.shape[1])
    return POD(w[:, :keep], sig[:keep], r, "energy")


def weight_pod(s, xh, d, rank: int, tol: float = 1e-12,
               svd_type: int = 1) -> POD:
    """Quarteroni Alg. 6.3: quadrature-weighted snapshots S~ = S D^(1/2)
    (reference weight_POD, POD.cpp:335-434)."""
    s = as_tensor(s)
    d = as_tensor(d, s.device, s.dtype)
    d_half = torch.sqrt(torch.clamp(
        torch.diagonal(d) if d.ndim == 2 else d, min=0.0))
    pod = energy_pod(s * d_half[None, :], xh, rank, tol, svd_type)
    return POD(pod.modes, pod.sigma, pod.rank, "weight")


def incremental_pod(snapshot_batches, rank: int, tol: float = 0.0) -> POD:
    """Streaming POD: feed snapshot batches as they are produced (e.g.
    one FOM parameter at a time) and keep a rank-capped factorization
    via Brand column appends: the working version of the reference's
    commented-out incremental-SVD intent (POD.cpp:464-799).  Memory is
    O(Nh * rank) regardless of the total snapshot count."""
    inc = IncrementalSVD(rank=rank)
    for batch in snapshot_batches:
        inc.update(batch)
    u, sig, _ = inc.factors()
    r = _energy_truncate(sig, tol, rank) if tol > 0 else min(rank, sig.shape[0])
    return POD(u[:, :rank], sig[:rank], r, "incremental")


def make_pod(pod_type: int, s, rank: int, tol: float, svd_type: int,
             xh=None, d=None) -> POD:
    """pod_type dispatch as in the reference driver (Diff1D.cpp:170-218):
    0 naive, 1 standard, 2 energy, 3 weight.  For 2/3 the driver builds the
    tridiagonal X_h = [-1, 2, -1] and D = 0.1 I inline; the same are the
    defaults here."""
    s = as_tensor(s)
    nh, ns = s.shape
    if pod_type in (2, 3) and xh is None:
        opts = dict(dtype=s.dtype, device=s.device)
        xh = (torch.diag(torch.full((nh,), 2.0, **opts))
              + torch.diag(torch.full((nh - 1,), -1.0, **opts), 1)
              + torch.diag(torch.full((nh - 1,), -1.0, **opts), -1))
    if pod_type == 3 and d is None:
        d = torch.full((ns,), 0.1, dtype=s.dtype, device=s.device)
    if pod_type == 0:
        return naive_pod(s, rank, svd_type, tol)
    if pod_type == 1:
        return standard_pod(s, rank, tol, svd_type)
    if pod_type == 2:
        return energy_pod(s, xh, rank, tol, svd_type)
    if pod_type == 3:
        return weight_pod(s, xh, d, rank, tol, svd_type)
    raise ValueError(f"unknown pod_type {pod_type}")
