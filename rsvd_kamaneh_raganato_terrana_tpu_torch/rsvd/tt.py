"""Randomized tensor-train decomposition (TT-SVD with the rSVD stage),
the JAX package's ``rsvd/tt.py``.

A tensor train (Oseledets 2011) stores d cores G_i of shape
(r_{i-1}, n_i, r_i), linear in d where Tucker's core grows like r^d.
Sequential TT-SVD where each step's truncated SVD of the current
unfolding (r_{i-1} n_i  x  prod_{j>i} n_j) is the randomized SVD: one
rSVD stage per mode, all GEMMs, each step shrinking the remainder by the
rank ratio.  ||A - TT||_F^2 <= sum_i eps_i^2 as in ST-HOSVD, so a
tolerance budget splits as tol/sqrt(d-1) per mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.convert import as_tensor
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    ieee_fp32,
    resolve_precision,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._modewise import (
    mode_contract,
    mode_spectrum,
    rank_for_budget,
    tighten_contract,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
    subspace_iteration,
)


def _tt_impl(a, ranks: Tuple[int, ...], p: int, q: int, seed,
             precision: str):
    prec = resolve_precision(precision)
    shape = a.shape
    cores = []
    rem = a.reshape(shape[0], -1)               # r_0 = 1 folded in
    r_prev = 1
    for i in range(a.ndim - 1):
        rem = rem.reshape(r_prev * shape[i], -1)
        r = min(ranks[i], min(rem.shape))
        l = min(r + p, min(rem.shape))
        omega = generate_omega(seed + 104729 * i, rem.shape[1], l,
                               rem.dtype, device=rem.device)
        q_mat = subspace_iteration(rem, omega, q, precision=prec)  # m x l
        u, rem = tighten_contract(rem, q_mat, r, prec)  # m x r, r x rest
        cores.append(u.reshape(r_prev, shape[i], r))
        r_prev = r
    cores.append(rem.reshape(r_prev, shape[-1], 1))
    return tuple(cores)


def tt_decompose(
    a,
    ranks: Sequence[int],
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    precision: str = "highest",
):
    """Randomized TT-SVD: returns d cores, cores[i] of shape
    (r_{i-1}, n_i, r_i) with r_0 = r_d = 1; ``ranks`` gives the d-1
    internal ranks (clipped to each unfolding's max).  A tensor stays on
    its device; any other array goes to the card."""
    a = as_tensor(a)
    if len(ranks) != a.ndim - 1:
        raise ValueError(f"need {a.ndim - 1} internal ranks, got "
                         f"{len(ranks)}")
    return _tt_impl(a, tuple(int(r) for r in ranks), p, q, seed, precision)


def tt_reconstruct(cores):
    """Contract a tensor train back to the full tensor."""
    out = cores[0]                               # (1, n_0, r_1)
    with ieee_fp32():
        for core in cores[1:]:
            # (..., r) x (r, n, r') -> (..., n, r')
            out = torch.tensordot(out, core, dims=([out.ndim - 1], [0]))
    return out[0, ..., 0]


def tt_ranks(cores) -> Tuple[int, ...]:
    """The internal ranks (r_1, ..., r_{d-1})."""
    return tuple(c.shape[2] for c in cores[:-1])


def tt_compression_ratio(cores) -> float:
    """dense element count / TT element count."""
    dense = float(math.prod(c.shape[1] for c in cores))
    stored = float(sum(math.prod(c.shape) for c in cores))
    return dense / stored


def tt_adaptive(
    a,
    tol: float,
    p: int = 10,
    q: int = 1,
    seed: int = 0,
    rank_cap: Optional[int] = None,
):
    """Tolerance-driven TT-SVD: pick each internal rank from the energy
    of the projected unfolding (per-mode budget tol/sqrt(d-1)), one
    spectrum fetch to the host per mode.  Returns ``(cores, ranks)``."""
    a = as_tensor(a)
    d = a.ndim
    budget = float(tol) / max(math.sqrt(d - 1), 1.0)
    cores = []
    rem = a.reshape(a.shape[0], -1)
    r_prev = 1
    for i in range(d - 1):
        rem = rem.reshape(r_prev * a.shape[i], -1)
        cap = int(min(rank_cap or min(rem.shape), min(rem.shape)))
        l = min(cap + p, min(rem.shape))
        q_mat, w, vecs, total = mode_spectrum(
            rem, seed + 104729 * i, l, q)
        r = rank_for_budget(w, total, budget, cap)
        u, rem = mode_contract(rem, q_mat, vecs, r)
        cores.append(u.reshape(r_prev, a.shape[i], r))
        r_prev = r
    cores.append(rem.reshape(r_prev, a.shape[-1], 1))
    return tuple(cores), tt_ranks(cores)
