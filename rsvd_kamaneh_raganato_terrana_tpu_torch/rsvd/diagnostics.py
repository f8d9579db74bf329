"""Subspace diagnostics and the serving health check (the JAX package's
``rsvd/diagnostics.py``, as far as the serving path needs it).

- ``factor_health``: the post-hoc check of a factorization triple that
  the serving configurations rely on (they have no rank-deficiency
  fallback): one set of device ops and ONE 5-element host fetch.
- ``principal_angles`` / ``subspace_distance``: angles between two
  subspaces, the metric for "did the sketch capture the same subspace".

The probe estimators (``range_error_estimate``,
``factorization_error_estimate``, ``spectral_norm_estimate``,
``stable_rank_estimate``) are not ported yet (ROADMAP.md): they draw from
a salted stream of JAX's RNG that torch cannot reproduce.
"""

from __future__ import annotations

import math

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION as _HI,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm


def principal_angles(u, v):
    """Principal angles between span(u) and span(v) (columns need not be
    orthonormal -- both are orthonormalized first).  Returns
    ``(angles_radians, cosines)``, angles ascending in [0, pi/2]."""
    qu, _ = torch.linalg.qr(u)
    qv, _ = torch.linalg.qr(v)
    sv = torch.linalg.svdvals(_mm(qu.T, qv, _HI))
    cos = torch.clamp(sv, 0.0, 1.0)   # descending, so arccos is ascending
    return torch.arccos(cos), cos


def subspace_distance(u, v):
    """sin of the largest principal angle (0 = identical spans, 1 = some
    direction fully missed)."""
    _, cos = principal_angles(u, v)
    return torch.sqrt(torch.clamp(1.0 - torch.min(cos) ** 2, min=0.0))


def _factor_health_device(u, s, v):
    """Five scalars from device ops alone: [finite, max |col-norm(U) - 1|,
    max |V^T V - I|, worst ascending violation of s, min s]; every stat
    reads unhealthy (0, inf, inf, inf, inf) when a factor is not
    finite."""
    dtype = torch.promote_types(torch.promote_types(u.dtype, s.dtype),
                                v.dtype)
    finite = (torch.isfinite(u).all() & torch.isfinite(s).all()
              & torch.isfinite(v).all())
    ucol = torch.max(torch.abs(torch.sqrt(torch.sum(u * u, dim=0)) - 1.0))
    vtv = _mm(v.T, v, _HI)
    vort = torch.max(torch.abs(
        vtv - torch.eye(vtv.shape[0], dtype=vtv.dtype, device=vtv.device)))
    asc = torch.max(torch.cat([torch.diff(s), s.new_zeros(1)]))
    stats = torch.stack([x.to(dtype) for x in
                         (finite, ucol, vort, asc, torch.min(s))])
    bad = torch.tensor([0.0] + [math.inf] * 4, dtype=dtype, device=s.device)
    return torch.where(finite, stats, bad)


def factor_health(u, s, v, tol: float = 1e-2) -> dict:
    """Cheap post-hoc health check of a factorization triple: all entries
    finite, U unit-column (orthonormal U also passes), V orthonormal, s
    descending.  Returns ``{"ok": bool, "finite": bool, "u_col_err":
    float, "v_orth_err": float, "s_ascending_violation": float, "s_min":
    float}``; ``ok`` is the conjunction at ``tol`` (default 1e-2: loose
    enough for the cholqr1/polar O(eps cond^2) serving orthogonality,
    tight enough that NaNs, short columns or ascending weights trip
    it)."""
    stats = _factor_health_device(u, s, v).tolist()   # the one fetch
    finite = bool(stats[0] > 0.5)
    out = {
        "finite": finite,
        "u_col_err": float(stats[1]),
        "v_orth_err": float(stats[2]),
        "s_ascending_violation": float(stats[3]),
        "s_min": float(stats[4]),
    }
    out["ok"] = (finite and out["u_col_err"] < tol
                 and out["v_orth_err"] < tol
                 and out["s_ascending_violation"] <= 0.0)
    return out
