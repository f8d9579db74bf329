"""Randomized tensor-train decomposition (TT-SVD with the rSVD stage),
the JAX package's ``rsvd/tt.py``.

A tensor train (Oseledets 2011) stores d cores G_i of shape
(r_{i-1}, n_i, r_i), linear in d where Tucker's core grows like r^d.
Sequential TT-SVD where each step's truncated SVD of the current
unfolding (r_{i-1} n_i  x  prod_{j>i} n_j) is the randomized SVD: one
rSVD stage per mode, all GEMMs, each step shrinking the remainder by the
rank ratio.  ||A - TT||_F^2 <= sum_i eps_i^2 as in ST-HOSVD, so a
tolerance budget splits as tol/sqrt(d-1) per mode.

A DTensor sharded on mode 0 is read block by block: the first
unfolding (n_0 x rest) is split by rows, its range finder and
contraction are the driver's split products (the sketch drawn whole),
and everything after the first step is replicated.  The first core
(1, n_0, r_1) comes back as a DTensor sharded on n_0, the others
replicated; ``tt_reconstruct`` of such cores gives the tensor sharded
on mode 0.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import (
    ieee_fp32,
    resolve_precision,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    is_dtensor,
    mesh_axis,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._modewise import (
    mode_contract,
    mode_spectrum,
    rank_for_budget,
    tighten_contract,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import _row_split
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    generate_omega,
    subspace_iteration,
)


def _first_unfolding(a):
    """A's mode-0 unfolding (n_0 x rest): of a tensor, or of a tensor
    split on mode 0, its row-split panel."""
    if isinstance(a, Sharded):
        return a.with_local(a.local.reshape(a.local.shape[0], -1))
    return a.reshape(a.shape[0], -1)


def _core(u, r_prev: int, n: int, r: int):
    """U (r_prev n x r) as a core (r_prev, n, r); the first core of a
    tensor split on mode 0 (U row-split) as a DTensor sharded on n."""
    if not isinstance(u, Sharded):
        return u.reshape(r_prev, n, r)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = u.local.reshape(1, u.local.shape[0], r).contiguous()
    shape = (1, n, r)
    placements = tuple(Shard(1) if d in u.rows.dims else Replicate()
                       for d in range(u.mesh.ndim))
    return DTensor.from_local(local, u.mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _tt_impl(a, ranks: Tuple[int, ...], p: int, q: int, seed,
             precision: str):
    prec = resolve_precision(precision)
    shape = a.shape
    cores = []
    rem = _first_unfolding(a)                   # r_0 = 1 folded in
    r_prev = 1
    for i in range(len(shape) - 1):
        if i:
            rem = rem.reshape(r_prev * shape[i], -1)
        r = min(ranks[i], min(rem.shape))
        l = min(r + p, min(rem.shape))
        omega = generate_omega(seed + 104729 * i, rem.shape[1], l,
                               rem.dtype, device=rem.device)
        q_mat = subspace_iteration(rem, omega, q, precision=prec)  # m x l
        u, rem = tighten_contract(rem, q_mat, r, prec)  # m x r, r x rest
        cores.append(_core(u, r_prev, shape[i], r))
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
    its device; any other array goes to the card; a DTensor sharded on
    mode 0 is read block by block (the module docstring)."""
    a = _row_split(a)
    if len(ranks) != len(a.shape) - 1:
        raise ValueError(f"need {len(a.shape) - 1} internal ranks, got "
                         f"{len(ranks)}")
    return _tt_impl(a, tuple(int(r) for r in ranks), p, q, seed, precision)


def tt_reconstruct(cores):
    """Contract a tensor train back to the full tensor (sharded on mode 0
    where the first core is sharded on n_0)."""
    first = cores[0]
    out = first.to_local() if is_dtensor(first) else first  # (1, n_0, r_1)
    with ieee_fp32():
        for core in cores[1:]:
            # (..., r) x (r, n, r') -> (..., n, r')
            out = torch.tensordot(out, core, dims=([out.ndim - 1], [0]))
    out = out[0, ..., 0]
    if not is_dtensor(first):
        return out
    mesh = first.device_mesh
    axis = mesh_axis(mesh, tuple(
        mesh.mesh_dim_names[d] for d, pl in enumerate(first.placements)
        if pl.is_shard()))
    return row_dtensor(out, mesh, axis, first.shape[1])


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
    spectrum fetch to the host per mode.  Returns ``(cores, ranks)``.  A
    DTensor sharded on mode 0 is read block by block (the module
    docstring)."""
    a = _row_split(a)
    d = len(a.shape)
    budget = float(tol) / max(math.sqrt(d - 1), 1.0)
    cores = []
    rem = _first_unfolding(a)
    r_prev = 1
    for i in range(d - 1):
        if i:
            rem = rem.reshape(r_prev * a.shape[i], -1)
        cap = int(min(rank_cap or min(rem.shape), min(rem.shape)))
        l = min(cap + p, min(rem.shape))
        q_mat, w, vecs, total = mode_spectrum(
            rem, seed + 104729 * i, l, q)
        r = rank_for_budget(w, total, budget, cap)
        u, rem = mode_contract(rem, q_mat, vecs, r)
        cores.append(_core(u, r_prev, a.shape[i], r))
        r_prev = r
    cores.append(rem.reshape(r_prev, a.shape[-1], 1))
    return tuple(cores), tt_ranks(cores)
