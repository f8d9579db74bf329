"""The numbers that decide ``correct``, each a gap between the program's
factors and the reference's on the same operand and sketch.

- ``s_gap``: max_i |s_i - s_ref_i| / s_ref_1 over the k values (singular
  values, or the serving finish's weights); ``s_rms`` the root mean
  square of the same;
- ``factor_gap``: ||U S V^T - U_r S_r V_r^T||_F / ||S_r||_F of the rank-k
  factors, from k x k Grams in f64 (rows of U may be split over ranks:
  ``comm`` sums them);
- ``lead_gap``: the same of the leading k0 components, k0 the cut in
  [k/2, k] where the reference's spectrum has its widest relative gap
  (:func:`lead_cut`): the rank-k factors turn by O(roundoff / gap) where
  s_k and s_k+1 nearly tie, the leading k0 do not;
- ``health_mismatch`` (serving): 1 where the program's health verdict
  differs from :func:`health` of its own factors, else 0.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def s_gap(s, s_ref) -> float:
    s, s_ref = s.to(F64), s_ref.to(F64).to(s.device)
    return float(torch.max(torch.abs(s - s_ref)) / s_ref[0])


def s_rms(s, s_ref) -> float:
    s, s_ref = s.to(F64), s_ref.to(F64).to(s.device)
    return float(torch.sqrt(torch.mean((s - s_ref) ** 2)) / s_ref[0])


def lead_cut(s_ref_all, k: int) -> int:
    """The k0 in [k/2, k] with the widest relative gap
    (s_k0 - s_k0+1) / s_k0 in the reference's l values."""
    s = s_ref_all.to(F64)
    lo = max(1, k // 2)
    rel = (s[lo - 1:k] - s[lo:k + 1]) / s[lo - 1:k]
    return lo + int(torch.argmax(rel))


def factor_gap(u, s, v, u_r, s_r, v_r, comm) -> float:
    """u, u_r: this rank's rows (f64 or f32); v, v_r whole."""
    x, xr = u.to(F64) * s.to(F64)[None, :], u_r.to(F64) * s_r.to(F64)[None, :]
    v, v_r = v.to(F64), v_r.to(F64)
    g = comm.sum(torch.stack([x.T @ x, x.T @ xr, xr.T @ xr]))
    sq = (torch.sum(g[0] * (v.T @ v)) - 2.0 * torch.sum(g[1] * (v.T @ v_r))
          + torch.sum(g[2] * (v_r.T @ v_r)))
    return float(torch.sqrt(torch.clamp(sq, min=0.0))
                 / torch.linalg.norm(s_r.to(F64)))


def health(u, s, v, tol: float = 1e-2) -> bool:
    """The serving health rule, plain: every entry finite, U's columns of
    unit norm, V orthonormal, s not ascending, each within ``tol``."""
    u, s, v = u.to(F64), s.to(F64), v.to(F64)
    if not all(bool(torch.isfinite(t).all()) for t in (u, s, v)):
        return False
    u_col = float(torch.max(torch.abs(torch.linalg.norm(u, dim=0) - 1.0)))
    eye = torch.eye(v.shape[1], dtype=F64, device=v.device)
    v_orth = float(torch.max(torch.abs(v.T @ v - eye)))
    rising = float(torch.max(s[1:] - s[:-1])) if s.numel() > 1 else 0.0
    return u_col < tol and v_orth < tol and rising <= 0.0
