"""Posterior error certificates, subspace diagnostics and the serving
health check (the JAX package's ``rsvd/diagnostics.py``).

- ``range_error_estimate``: a high-probability upper bound on
  ||(I - QQ^T) A||_2 from r Gaussian probes (Halko-Martinsson-Tropp
  2011, eq. 4.3): with probability >= 1 - 10^{-r},
  ||E||_2 <= 10 sqrt(2/pi) max_i ||E g_i||_2.
- ``factorization_error_estimate``: the same certificate for a
  (U, s, V) triple.
- ``spectral_norm_estimate`` / ``stable_rank_estimate``: ||A||_2 by
  power iteration on the Gram operator, and ||A||_F^2 / ||A||_2^2.
- ``factor_health``: the post-hoc check of a factorization triple that
  the serving configurations rely on (they have no rank-deficiency
  fallback): one set of device ops and ONE 5-element host fetch; a
  row-sharded U (as ``rsvd_serving`` returns it) is read by its rows.
- ``principal_angles`` / ``subspace_distance``: angles between two
  subspaces, the metric for "did the sketch capture the same subspace".

The probes come from a stream of their own: the seed's generator folded
with a fixed tag (``_probe_key``), disjoint from ``generate_omega``'s
stream for the same seed, as the JAX package's salted key is.  They are
torch Philox draws, not JAX's threefry values.

The certificates and the norm estimates take a DTensor whose rows are
sharded (Q, U row-sharded alike, as ``rsvd`` returns them): the probes
are drawn whole, as on one card, the m-sized panels stay row-split, and
the column norms and the power iteration's norms are completed over the
rows (``rsvd/_sharded.py``), so the estimates come back replicated.  The
certificates also take a sparse operand split by its entries
(``core/distributed.py::EntrySplit``; a row-sharded Q or U is then
gathered): its products are all-reduced whole panels.  The norm
estimates refuse one, as the JAX package fails on a BCOO so placed.
"""

from __future__ import annotations

import math

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    EntrySplit,
    Sharded,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import span
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    gaussian,
    key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.linalg.power import (
    power_triplet,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION as _HI,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _like,
    _local,
    _norm,
    _reduce,
    _row_split,
    _sharded_view,
    _whole,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import _mm

# The certificate needs probes INDEPENDENT of the factorization it
# certifies.  generate_omega(seed, ...) and these estimators both default
# to seed 0, so unsalted probes would be Omega itself and (I - QQ^T) A g
# would be ~0 by construction.  Folding a fixed tag into the seed's key
# puts the probes on a disjoint stream for every seed (the JAX package's
# tag).
_PROBE_TAG = 0x9E3779B9


def _probe_key(seed, device):
    return fold_in_shard(key_from_seed(seed, device), _PROBE_TAG)


def _probes(seed, shape, dtype, device):
    """Standard-normal probes of ``shape`` from the salted stream."""
    return gaussian(_probe_key(seed, device), shape, dtype)


def _certificate(resid):
    """10 sqrt(2/pi) max_i ||resid[:, i]||_2 (of a row-split residual,
    its column sums of squares all-reduced)."""
    local = _local(resid)
    norms = torch.sqrt(_reduce(torch.sum(local * local, dim=0), resid))
    return 10.0 * math.sqrt(2.0 / math.pi) * torch.max(norms)


def range_error_estimate(a, q_mat, seed=0, num_probes: int = 10):
    """Certified upper bound on ||(I - QQ^T) A||_2, holding with
    probability >= 1 - 10^{-num_probes} over the probes (drawn from a
    stream disjoint from ``generate_omega``'s for the same seed)."""
    a, q_mat = _row_split(a), _sharded_view(q_mat)
    if isinstance(a, EntrySplit):
        q_mat = _whole(q_mat)
    g = _probes(seed, (a.shape[1], num_probes), a.dtype, a.device)
    ag = _mm(a, g, _HI)                            # m x r
    proj = _mm(q_mat, _mm(q_mat.T, ag, _HI), _HI)
    return _certificate(_like(ag, _local(ag) - _local(proj)))


def factorization_error_estimate(a, u, s, v, seed=0, num_probes: int = 10):
    """Certified upper bound on ||A - U diag(s) V^T||_2 (the same probe
    argument applied to the factorization's residual operator; probes
    from the salted stream, see ``_probe_key``)."""
    a, u = _row_split(a), _sharded_view(u)
    if isinstance(a, EntrySplit):
        u = _whole(u)
    g = _probes(seed, (a.shape[1], num_probes), a.dtype, a.device)
    ag = _mm(a, g, _HI)
    fit = _mm(_like(u, _local(u) * s[None, :]), _mm(v.T, g, _HI), _HI)
    return _certificate(_like(ag, _local(ag) - _local(fit)))


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
    finite.  A row-sharded U is read by its rows: two small all-reduces
    (the finite flag, the column sums of squares), no gather."""
    u = _sharded_view(u)
    local = _local(u)
    dtype = torch.promote_types(torch.promote_types(local.dtype, s.dtype),
                                v.dtype)
    # a row-split U: its finite flag and column sums of squares completed
    # over the rows
    u_finite = _reduce(torch.isfinite(local).all().to(dtype), u, "min") > 0
    finite = u_finite & torch.isfinite(s).all() & torch.isfinite(v).all()
    ucol = torch.max(torch.abs(torch.sqrt(
        _reduce(torch.sum(local * local, dim=0), u)) - 1.0))
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
    it).  Runs under the span ``rsvd/health``, its fetch under
    ``rsvd/read/health_fetch`` (``core/profiling.py``)."""
    with span("health"):
        stats = _factor_health_device(u, s, v)
        with span("read/health_fetch"):
            stats = stats.tolist()                    # the one fetch
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


def _refuse_entry_split(a, name: str, jax_error: str):
    """Raise for an entry-split sparse operand, naming what the JAX
    package does with its counterpart (a BCOO placed with the row
    sharding): it fails too, so the port adds no such path."""
    if isinstance(a, EntrySplit):
        raise TypeError(f"{name} takes no sparse operand split by entries "
                        "over the ranks; the JAX package fails on a BCOO "
                        f"placed with P('rows') as well ({jax_error})")


def spectral_norm_estimate(a, seed=0, num_iters: int = 30):
    """||A||_2 estimate by power iteration on the Gram operator
    (x <- A^T (A x)).  A lower bound that converges geometrically in
    (sigma_2/sigma_1)^2."""
    a = _row_split(a)
    _refuse_entry_split(a, "spectral_norm_estimate", "power_triplet's "
                        "jnp.matmul raises 'matmul requires ndarray or "
                        "scalar arguments, got BCOO'")
    x0 = _probes(seed, (a.shape[1],), a.dtype, a.device)
    if not isinstance(a, Sharded):
        sigma, _, _ = power_triplet(a, x0, num_iters)
        return sigma
    # power_triplet's steps on the blocks: A v stays row-split, A^T (A v)
    # is all-reduced, ||A v|| completed over the rows
    v = x0 / torch.linalg.norm(x0)
    for _ in range(num_iters):
        z = _mm(a.T, _mm(a, v[:, None], _HI), _HI)[:, 0]
        v = z / torch.linalg.norm(z)
    return _norm(_mm(a, v[:, None], _HI))


def stable_rank_estimate(a, seed=0, num_iters: int = 30):
    """Stable rank srank(A) = ||A||_F^2 / ||A||_2^2, with ||A||_F exact
    and ||A||_2 from :func:`spectral_norm_estimate` (so a slight
    over-estimate while the power iteration has not converged)."""
    a = _row_split(a)
    _refuse_entry_split(a, "stable_rank_estimate", "jnp.asarray of the "
                        "BCOO raises 'setting an array element with a "
                        "sequence'")
    fro_sq = _reduce(torch.sum(torch.square(_local(a))), a)
    sig = spectral_norm_estimate(a, seed=seed, num_iters=num_iters)
    return fro_sq / torch.clamp(sig * sig, min=torch.finfo(a.dtype).tiny)
