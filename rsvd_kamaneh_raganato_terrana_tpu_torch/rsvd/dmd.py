"""Dynamic Mode Decomposition (exact DMD; the JAX package's
``rsvd/dmd.py``; Tu, Rowley et al. 2014): a best-fit linear operator
Y ~ A X over snapshot pairs, whose eigenpairs are growth/decay rates,
frequencies and spatially coherent modes.

All O(n m) work runs on the tensor's device: the rank-k truncated SVD
of X (the driver's ``rsvd``) and the products that build the k x k
A_tilde = U^T Y V S^{-1}.  The k x k non-symmetric eigendecomposition,
the modes' product with its eigenvectors and the amplitudes'
least-squares fit run on the host in numpy f64, as in the JAX package,
and the result's fields are numpy arrays.

A snapshot matrix whose rows (the state) are sharded, a DTensor, goes
through the driver's sharded ``rsvd``; A_tilde's product is all-reduced,
the k-wide panel Y V S^{-1} and the first snapshot are gathered for the
amplitudes' host fit, and the modes come back as a row-sharded complex
DTensor (this rank's rows of Phi, on the snapshots' device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import to_numpy
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import Sharded
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _row_split,
    _sharded_view,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm, rsvd


class DmdResult(NamedTuple):
    modes: np.ndarray        # n x k complex -- exact DMD modes Phi (a
    #                          row-sharded DTensor for sharded snapshots)
    eigs: np.ndarray         # k complex -- discrete-time eigenvalues
    omega: np.ndarray        # k complex -- continuous-time log(eigs)/dt
    amplitudes: np.ndarray   # k complex -- b = Phi^+ x_0
    singular_values: np.ndarray   # k -- of the snapshot matrix X
    dt: float


def _dmd_device_part(x, y, k: int, p: int, q: int, seed: int):
    """The rank-k SVD of X and the projected operator A_tilde."""
    u, s, v = rsvd(x, k=k, p=p, q=q, seed=seed, method="eigh")
    u = _sharded_view(u)
    yv_sinv = _mm(y, v)
    yv_sinv = _like(yv_sinv, _local(yv_sinv) / s[None, :])   # n x k
    atilde = _mm(u.T, yv_sinv)                   # k x k
    return s, yv_sinv, atilde


def _host64(x) -> np.ndarray:
    return (to_numpy(x) if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)


def dmd(snapshots, k: int, dt: float = 1.0, p: int = 10, q: int = 2,
        seed: int = 0) -> DmdResult:
    """Exact DMD of a time-ordered snapshot matrix (n x (m+1) columns
    x_0 ... x_m, uniform spacing dt), rank k via the rSVD driver.  A
    tensor stays on its device; any other array goes to the card; a
    DTensor whose rows are sharded is read block by block (the module
    docstring)."""
    snapshots = _row_split(snapshots)
    local = _local(snapshots)
    x = _like(snapshots, local[:, :-1])
    y = _like(snapshots, local[:, 1:])
    s, yv_sinv, atilde = _dmd_device_part(x, y, k, p, q, seed)

    lam, w = np.linalg.eig(_host64(atilde))
    # exact DMD modes (Tu et al. Thm 1): Phi = Y V S^{-1} W
    phi = _host64(_whole(yv_sinv)) @ w
    omega = np.log(lam.astype(np.complex128)) / dt
    first = _whole(_like(snapshots, local[:, :1]))[:, 0]
    b, *_ = np.linalg.lstsq(phi, _host64(first), rcond=None)
    modes = phi
    if isinstance(snapshots, Sharded):
        modes = snapshots.keep_rows(torch.as_tensor(
            phi, device=local.device)).to_dtensor()
    return DmdResult(modes, lam, omega, b, _host64(s), float(dt))


def dmd_predict(res: DmdResult, t) -> np.ndarray:
    """x(t) = Re( Phi diag(exp(omega t)) b ) for scalar or vector t:
    reconstruction on the training window, forecast beyond it."""
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    dynamics = np.exp(np.outer(res.omega, t)) * res.amplitudes[:, None]
    out = np.real(res.modes @ dynamics)          # n x len(t)
    return out[:, 0] if t.shape == (1,) else out


def dmd_reconstruction_error(res: DmdResult, snapshots) -> float:
    """Relative Frobenius error of the DMD reconstruction over the whole
    training window."""
    snaps = _host64(snapshots)
    times = np.arange(snaps.shape[1]) * res.dt
    recon = dmd_predict(res, times)
    return float(np.linalg.norm(recon - snaps) / np.linalg.norm(snaps))
