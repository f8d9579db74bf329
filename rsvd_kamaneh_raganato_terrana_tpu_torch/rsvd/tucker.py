"""Randomized Tucker decomposition (sequentially-truncated randomized
HOSVD), the JAX package's ``rsvd/tucker.py``.

A ~ G x_1 U1 x_2 U2 ... x_d Ud with orthonormal factor matrices U_i
(n_i x r_i) and core G (r_1 x ... x r_d).  ST-HOSVD (Vannieuwenhoven et
al. 2012) with the matrix stage replaced by the rSVD range finder: for
each mode in turn, largest first, sketch the mode unfolding of the
CURRENT (already partially compressed) tensor, take U_i from the range
basis, and contract it in at once, so later modes work on a tensor that
shrinks geometrically.

Error: ||A - [G; U]||_F^2 <= sum_i eps_i^2, eps_i mode i's truncation
error.  Each mode's range finder uses the driver's 'robust' QR, which
reads its fallback flag on the host once per QR, as the main path does.

A mode's unfolding is a view where its axes merge without a copy (the
input's first or last mode), else a copy of the current core; each
mode's Omega is drawn inside the sketch (``driver._sketch``) and freed
after it, so it is not held through the power rounds. Spans
(``core/profiling.py``): ``rsvd/call`` once a call, ``rsvd/mode`` once a
mode, ``rsvd/unfold`` around each unfolding (empty on the device where
it is a view), and the driver's and
``_modewise``'s own below them; :func:`unfold_tally` counts the calls,
the copies and the bytes they wrote.

A DTensor sharded on mode 0 is read block by block: mode 0's unfolding
is split by rows, every other mode's by columns (held as the transpose
of a row split), and the driver's split products all-reduce the Grams
and contractions that cross the split; the sketches are drawn whole, as
on one card.  Once mode 0 is contracted the core is replicated.  U_0
comes back row-sharded, the other factors and the core replicated.
``tucker_adaptive`` reads its tensor the same way, its rank rule
reading each mode's spectrum on the host as on one card, and
``tucker_reconstruct`` of a row-sharded U_0 gives the tensor sharded on
mode 0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    resolve_precision,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    from_dtensor,
    is_dtensor,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.profiling import (
    call_span,
    span,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._modewise import (
    mode_contract,
    mode_spectrum,
    rank_for_budget,
    tighten_contract,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _row_split,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    generate_omega,
    subspace_iteration,
)

_HI = DOT_PRECISION

# tucker / tucker_adaptive calls, copying unfoldings and the bytes they
# wrote since the last reset_unfold_tally()
_unfold_counts = [0, 0, 0]


def unfold_tally() -> dict:
    """{calls, copies, bytes} since the last :func:`reset_unfold_tally`:
    calls of :func:`tucker` and :func:`tucker_adaptive`, the unfoldings
    that copied the current core, and the bytes those copies wrote (an
    unfolding that is a view counts none)."""
    return dict(zip(("calls", "copies", "bytes"), _unfold_counts))


def reset_unfold_tally() -> None:
    """Zero :func:`unfold_tally`."""
    _unfold_counts[:] = [0, 0, 0]


def _unfold(t, mode: int):
    """Mode-`mode` unfolding: n_mode x prod(other dims), under the
    ``rsvd/unfold`` span; a copy (where the axes do not merge) is
    counted in :func:`unfold_tally`."""
    with span("unfold"):
        out = t.movedim(mode, 0).reshape(t.shape[mode], -1)
    if out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
        _unfold_counts[1] += 1
        _unfold_counts[2] += out.numel() * out.element_size()
    return out


def _fold(mat, mode: int, shape):
    """Inverse of `_unfold` for a tensor of (full) `shape`."""
    shp = (mat.shape[0],) + tuple(s for i, s in enumerate(shape)
                                  if i != mode)
    return mat.reshape(shp).movedim(0, mode)


def mode_dot(t, mat, mode: int, precision=_HI):
    """Mode-`mode` product t x_mode mat (mat: r x n_mode contracts the
    mode-`mode` axis)."""
    moved = t.movedim(mode, 0)
    out = _mm(mat, moved.reshape(moved.shape[0], -1), precision)
    return out.reshape((mat.shape[0],) + tuple(moved.shape[1:])).movedim(
        0, mode)


def _order(shape):
    """Modes in decreasing size (stable): each contraction shrinks the
    tensor the most before later, cheaper modes are sketched."""
    return sorted(range(len(shape)), key=lambda i: -shape[i])


def _split_unfold(view, local, mode: int):
    """The mode unfolding of a tensor split on mode 0 (``view``, its
    :class:`Sharded` view, ``local`` its current block): mode 0's by
    rows; any other mode's columns run over mode 0 outermost, so each
    rank holds one block of them, held as the transpose of a row
    split."""
    unf = _unfold(local, mode)
    if mode == 0:
        return Sharded(unf, (view.shape[0], unf.shape[1]), view.mesh,
                       view.rows)
    cols = unf.shape[1] * view.rows.size
    return Sharded(unf.T, (cols, unf.shape[0]), view.mesh, view.rows).T


def _tucker_impl(a, seed, ranks: Tuple[int, ...], p: int, q: int,
                 precision: str):
    prec = resolve_precision(precision)
    view = a if isinstance(a, Sharded) else None
    core = a.local if view else a                  # this rank's block
    shape = list(a.shape)                          # the whole core's
    factors = [None] * len(shape)
    for mode in _order(a.shape):
        with span("mode"):
            unf = (_split_unfold(view, core, mode) if view
                   else _unfold(core, mode))       # n_mode x rest
            rest = math.prod(shape) // shape[mode]
            l = min(ranks[mode] + p, shape[mode], rest)
            # drawn inside the sketch, freed before the power rounds
            q_mat = subspace_iteration(
                unf, lambda: generate_omega(seed + 7919 * mode, rest, l,
                                            core.dtype, device=core.device),
                q, precision=prec)
            u, contracted = tighten_contract(unf, q_mat, ranks[mode], prec)
            factors[mode] = _to_api(u)
            shape[mode] = ranks[mode]
            if view and mode == 0:
                view = None                        # contracted: replicated
            elif view:
                contracted = contracted.T.local.T  # this rank's columns
            core = _fold(contracted, mode, shape if view is None
                         else (core.shape[0],) + tuple(shape[1:]))
    return core, tuple(factors)


def tucker(
    a,
    ranks: Sequence[int],
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    precision: str = "highest",
):
    """Randomized Tucker: returns ``(core, factors)`` with
    ``core.shape == tuple(r_eff)`` and ``factors[i].shape ==
    (a.shape[i], r_eff[i])``, each factor orthonormal.  ``r_eff`` is
    ``ranks`` clipped to what each mode's unfolding can support: a
    mode's rank can never exceed min(n_i, product of the OTHER modes'
    dims as they stand when that mode is processed -- earlier modes are
    already contracted to their ranks).  Read the effective ranks off
    ``core.shape``.

    ``p``/``q``/``precision`` are the rSVD stage-A knobs (oversampling,
    power iterations, product precision) applied per mode.  A tensor
    stays on its device; any other array goes to the card; a DTensor
    sharded on mode 0 is read block by block (the module docstring)."""
    a = _row_split(a)
    if len(ranks) != len(a.shape):
        raise ValueError(f"need {len(a.shape)} ranks, got {len(ranks)}")
    # mirror _tucker_impl's processing order so the clip accounts for
    # already-contracted modes shrinking the unfolding
    eff = [int(min(r, n)) for r, n in zip(ranks, a.shape)]
    cur = list(a.shape)
    for mode in _order(a.shape):
        rest = math.prod(s for j, s in enumerate(cur) if j != mode)
        eff[mode] = min(eff[mode], rest)
        cur[mode] = eff[mode]
    _unfold_counts[0] += 1
    with call_span():
        return _tucker_impl(a, seed, tuple(eff), p, q, precision)


def tucker_reconstruct(core, factors, precision=_HI):
    """A ~ core x_1 U1 x_2 U2 ... x_d Ud; with U1 row-sharded, the tensor
    sharded on mode 0 (each rank contracts its rows of U1)."""
    view = from_dtensor(factors[0]) if is_dtensor(factors[0]) else None
    out = core
    for mode, u in enumerate(factors):
        out = mode_dot(out, view.local if view and mode == 0 else u, mode,
                       precision)
    if view is not None:
        return row_dtensor(out, view.mesh, view.rows, view.shape[0])
    return out


def tucker_adaptive(
    a,
    tol: float,
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    rank_cap: Optional[Sequence[int]] = None,
):
    """Rank-adaptive ST-HOSVD: pick each mode's rank from the energy of
    the projected unfolding so the total relative error meets ``tol``
    (per-mode budget tol/sqrt(d), by the ST-HOSVD error split).

    One small spectrum fetch to the host per mode.  Returns ``(core,
    factors, ranks)``.  A DTensor sharded on mode 0 is read block by
    block (the module docstring)."""
    a = _row_split(a)
    _unfold_counts[0] += 1
    with call_span():
        return _adaptive_impl(a, tol, p, q, seed, rank_cap)


def _adaptive_impl(a, tol, p, q, seed, rank_cap):
    d = len(a.shape)
    budget = float(tol) / math.sqrt(d)
    caps = tuple(rank_cap) if rank_cap is not None else a.shape
    view = a if isinstance(a, Sharded) else None
    core = a.local if view else a                  # this rank's block
    shape = list(a.shape)                          # the whole core's
    factors = [None] * d
    for mode in _order(a.shape):
        with span("mode"):
            unf = (_split_unfold(view, core, mode) if view
                   else _unfold(core, mode))
            cap = int(min(caps[mode], min(unf.shape)))
            l = min(cap + p, min(unf.shape))
            q_mat, w, vecs, total = mode_spectrum(
                unf, seed + 7919 * mode, l, q)
            r = rank_for_budget(w, total, budget, cap)
            u, contracted = mode_contract(unf, q_mat, vecs, r)
            factors[mode] = _to_api(u)
            shape[mode] = r
            if view and mode == 0:
                view = None                        # contracted: replicated
            elif view:
                contracted = contracted.T.local.T  # this rank's columns
            core = _fold(contracted, mode, shape if view is None
                         else (core.shape[0],) + tuple(shape[1:]))
    return core, tuple(factors), tuple(f.shape[1] for f in factors)
