"""Shared sketched-unfolding machinery for the tensor decompositions (the
JAX package's ``rsvd/_modewise.py``).

Both Tucker/ST-HOSVD (``rsvd/tucker.py``) and TT-SVD (``rsvd/tt.py``)
repeat the same per-mode move: sketch the current unfolding with the
rSVD range finder, tighten the oversampled basis to exactly r directions
via the projected Gram's eigenvectors, and contract the factor into the
remainder.

The projected Gram's eigh (under the ``rsvd/tail`` span) is
``core/device.py::eigh`` (torch's eigh plus one Newton--Schulz step):
``jnp.linalg.eigh`` returns eigenvectors orthogonal to working
precision, torch's f32 eigh on the card only to ~1e-5. The
tolerance-adaptive variants fetch one spectrum per mode to the host
between :func:`mode_spectrum` and :func:`mode_contract`, the same host
sync the JAX package makes between its two jitted pieces.

An unfolding may be split over the ranks (``core/distributed.py::
Sharded``: mode 0's by rows, another mode's by columns, held as the
transpose of a row split); the driver's split products all-reduce what
crosses the split, and the energy ||unf||_F^2 is summed over the
ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import eigh
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import span
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _local,
    _reduce,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    generate_omega,
    subspace_iteration,
)


def tighten_contract(unf, q_mat, r: int, prec):
    """Given the range basis Q of an unfolding, return (U: m x r,
    U^T unf) with U the top-r projected directions -- descending
    eigenvectors of (Q^T unf)(Q^T unf)^T mapped back through Q."""
    b = _mm(q_mat.T, unf, prec)
    g = _mm(b, b.T, DOT_PRECISION)
    with span("tail"):
        _, vecs = eigh(0.5 * (g + g.T))
    u = _mm(q_mat, vecs.flip(1)[:, :r])
    return u, _mm(u.T, unf, prec)


def mode_spectrum(unf, seed, l: int, q: int):
    """Sketch one unfolding and return (Q, descending projected-Gram
    eigenvalues, descending eigenvectors, total energy ||unf||_F^2).
    Omega is drawn from ``seed`` on the unfolding's device."""
    omega = generate_omega(seed, unf.shape[1], l, unf.dtype,
                           device=unf.device)
    q_mat = subspace_iteration(unf, omega, q)
    b = _mm(q_mat.T, unf, DOT_PRECISION)
    g = _mm(b, b.T, DOT_PRECISION)
    with span("tail"):
        w, vecs = eigh(0.5 * (g + g.T))
    total = _reduce(torch.sum(torch.square(_local(unf))), unf)
    return q_mat, w.flip(0), vecs.flip(1), total


def mode_contract(unf, q_mat, vecs, r: int):
    """Materialize the rank-r factor and the contracted remainder."""
    u = _mm(q_mat, vecs[:, :r])
    return u, _mm(u.T, unf, DOT_PRECISION)


def rank_for_budget(w, total, budget: float, cap: int) -> int:
    """The smallest rank whose discarded projected energy is at most
    budget^2 of the total (``cap`` when none is), on the host in f64:
    the rank decision of ``tucker_adaptive`` and ``tt_adaptive``."""
    w = np.maximum(w.detach().cpu().numpy().astype(np.float64), 0.0)
    total = float(total)
    resid = np.maximum(total - np.cumsum(w), 0.0)
    ok = np.nonzero(resid <= (budget * budget) * total)[0]
    return min(int(ok[0]) + 1 if ok.size else cap, cap)
