"""CP (canonical polyadic) decomposition by ALS, the JAX package's
``rsvd/cp.py``: A ~ sum_r w_r * f^(1)_r o f^(2)_r o ... o f^(d)_r.

Alternating least squares where each mode update is the normal-equation
form over the Khatri-Rao product,

    F_i <- A_(i) * KR(F_d..F_1, skip i) * pinv( had_{j != i} F_j^T F_j ),

one big GEMM against the unfolding, an r x r Hadamard-of-Grams solve
(a Cholesky solve through ``core/device.py::cholesky``, so a failed
factorization gives NaN as XLA's does) and a column renormalization.
The sweeps are a Python loop over device tensors with no host read.
Initialization is the rSVD range finder per mode (HOSVD-style).

``method='rand'`` is CPRAND (Battaglino, Ballard & Kolda 2018):
fiber-sampled updates whose per-sweep cost is independent of prod(n).
The fibers of sweep ``it``, mode ``i`` are drawn by
:func:`_fiber_indices` from the generator ``fold_in_shard(
fold_in_shard(key0, it), i)``, key0 the seed's key folded with 12345:
torch Philox draws, not the JAX package's threefry values.

A DTensor sharded on mode 0 is read block by block: the initial range
finders are the driver's split products (Tucker's unfoldings), F_1
(mode 0's factor) stays row-split and the other factors replicated.
Mode 0's MTTKRP is local; every other mode's takes this rank's slice of
the Khatri-Rao rows (mode 0 varies slowest) and all-reduces the partial
sums; Grams and column norms of F_1 are completed over the ranks.
CPRAND draws its fibers whole, by global index: the rows of F_1 they
meet are taken from the ranks that hold them, and a fiber's entries are
read by the rank that holds its mode-0 index, the products all-reduced.
F_1 comes back row-sharded.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from rsvd_kamaneh_raganato_terrana_tpu_torch.core import collectives
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.device import cholesky
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.distributed import (
    Sharded,
    from_dtensor,
    is_dtensor,
    row_dtensor,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.core.rng import (
    fold_in_shard,
    key_from_seed,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.ops.primitives import (
    DOT_PRECISION,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._modewise import (
    tighten_contract,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd._sharded import (
    _cols,
    _like,
    _local,
    _norm,
    _row_block,
    _row_split,
    _take_rows,
    _to_api,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.driver import (
    _mm,
    generate_omega,
    subspace_iteration,
)
from rsvd_kamaneh_raganato_terrana_tpu_torch.rsvd.tucker import (
    _split_unfold,
    _unfold,
)


def khatri_rao(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Column-wise Khatri-Rao product, C-order nesting (first factor
    varies slowest) -- matches `_unfold`'s row-major flattening."""
    out = mats[0]
    r = out.shape[1]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, r)
    return out


def _cp_init(a, seed, rank: int):
    """rSVD-subspace init per mode: F_i = top-r left singular directions
    of the unfolding (HOSVD-style); padded with seeded Gaussian columns
    when a mode can't support the full rank.  Mode 0's factor of a
    tensor split on mode 0 stays row-split."""
    view = a if isinstance(a, Sharded) else None
    factors = []
    for i in range(len(a.shape)):
        unf = _split_unfold(view, a.local, i) if view else _unfold(a, i)
        r_i = min(rank, min(unf.shape))
        omega = generate_omega(seed + 31 * i, unf.shape[1], r_i, a.dtype,
                               device=a.device)
        q_mat = subspace_iteration(unf, omega, q=1)
        u, _ = tighten_contract(unf, q_mat, r_i, DOT_PRECISION)
        if r_i < rank:
            extra = generate_omega(seed + 97 * i, a.shape[i], rank - r_i,
                                   a.dtype, device=a.device)
            u = _like(u, torch.cat([_local(u), _row_block(
                u, extra / math.sqrt(float(a.shape[i])))], dim=1))
        factors.append(u)
    return factors


def _regularize(g, rank: int, dtype):
    """Symmetric-solve floor: eps * (trace + 1) -- the absolute +1 keeps
    the solve nonsingular even for an all-zero Gram (zero tensor,
    collapsed factor)."""
    eye = torch.eye(rank, dtype=dtype, device=g.device)
    return g + torch.finfo(dtype).eps * (torch.trace(g) + 1.0) * eye


def _solve_pos(g, rhs):
    """rhs G^{-1} for symmetric positive definite G (``jax.scipy.linalg.
    solve(G^T, rhs^T, assume_a='pos')^T``), by a Cholesky solve."""
    return torch.cholesky_solve(rhs.T, cholesky(g.T)).T


def _renormalize(f, eps):
    return _like(f, _local(f) / torch.clamp(_norm(f, dim=0),
                                            min=eps)[None, :])


def _cp_finalize(factors, eps):
    """Extract weights from the last mode, sort descending."""
    last = factors[-1]
    weights = torch.linalg.norm(last, dim=0)
    last = last / torch.clamp(weights, min=eps)[None, :]
    order = torch.argsort(-weights, stable=True)
    return weights[order], tuple(
        [_cols(f, order) for f in factors[:-1]] + [last[:, order]])


def _mttkrp_done(a, i: int, part):
    """Mode i's MTTKRP from this rank's ``part``: mode 0's rows are this
    rank's (of a tensor split on mode 0, a row-split panel), any other
    mode's partial sums over the mode-0 blocks are all-reduced."""
    if not isinstance(a, Sharded):
        return part
    if i == 0:
        return a.with_local(part)
    return collectives.all_reduce(part, a.rows.group)


def _cp_als_impl(a, seed, rank: int, iters: int):
    d = len(a.shape)
    unfolds = [_unfold(_local(a), i) for i in range(d)]  # this rank's
    fs = _cp_init(a, seed, rank)
    eps = 1e-30
    for _ in range(iters):
        for i in range(d):
            others = [fs[j] for j in range(d) if j != i]
            kr = khatri_rao([_local(f) for f in others])    # prod n_j x r
            g = torch.ones((rank, rank), dtype=a.dtype, device=a.device)
            for f in others:
                g = g * _mm(f.T, f)                         # Hadamard Grams
            mttkrp = _mttkrp_done(a, i, _mm(unfolds[i], kr))  # n_i x r
            f_new = _like(mttkrp, _solve_pos(
                _regularize(g, rank, a.dtype), _local(mttkrp)))
            # renormalize columns (weights are re-absorbed on the last
            # mode each sweep, the standard CP-ALS convention)
            fs[i] = _renormalize(f_new, eps) if i < d - 1 else f_new
    return _cp_finalize(fs, eps)


def _fiber_indices(key0, it: int, i: int, shape, num_samples: int):
    """The CPRAND sample of sweep ``it``, mode ``i``: one uniform index
    vector (num_samples,) for each other mode, in mode order."""
    gen = fold_in_shard(fold_in_shard(key0, it), i)
    return [torch.randint(0, shape[j], (num_samples,), generator=gen,
                          device=gen.device)
            for j in range(len(shape)) if j != i]


def _cp_rand_impl(a, seed, rank: int, iters: int, num_samples: int):
    """CPRAND: each mode update solves a fiber-sampled least squares -- S
    rows of the Khatri-Rao product formed directly as Hadamard products
    of factor rows, and the matching S tensor fibers gathered from the
    flat tensor by int64 index (no per-mode unfolding copies)."""
    d = len(a.shape)
    shape = a.shape
    strides = [math.prod(shape[j + 1:]) for j in range(d)]
    a_flat = _local(a).reshape(-1)                  # this rank's block
    start0 = a.row_start if isinstance(a, Sharded) else 0
    fs = _cp_init(a, seed, rank)
    eps = 1e-30
    key0 = fold_in_shard(key_from_seed(seed, a.device), 12345)
    for it in range(iters):
        for i in range(d):
            others = [j for j in range(d) if j != i]
            idxs = _fiber_indices(key0, it, i, shape, num_samples)
            kr_s = torch.ones((num_samples, rank), dtype=a.dtype,
                              device=a.device)
            base = torch.zeros((num_samples,), dtype=torch.int64,
                               device=a.device)
            for j, idx in zip(others, idxs):
                kr_s = kr_s * _take_rows(fs[j], idx)
                base = base + idx.to(torch.int64) * strides[j]
            if isinstance(a, Sharded) and i:
                # the fibers whose mode-0 index this rank holds
                a_s = _fibers_held(a, a_flat, idxs[0], base, i, strides)
            else:
                along = torch.arange(_local(a).shape[i],
                                     device=a.device) * strides[i]
                a_s = a_flat[base[None, :] + along[:, None]]  # n_i x S
            g = _regularize(_mm(kr_s.T, kr_s), rank, a.dtype)
            mttkrp = _mttkrp_done(a, i, _mm(a_s, kr_s))
            f_new = _like(mttkrp, _solve_pos(g, _local(mttkrp)))
            fs[i] = _renormalize(f_new, eps) if i < d - 1 else f_new
    return _cp_finalize(fs, eps)


def _fibers_held(a, a_flat, idx0, base, i: int, strides):
    """The n_i x S fiber block of a tensor split on mode 0, this rank's
    entries filled (the fibers whose mode-0 index it holds), zeros
    elsewhere; ``base`` is each fiber's global flat offset."""
    rows = a.local.shape[0]
    mine = (idx0 >= a.row_start) & (idx0 < a.row_start + rows)
    along = torch.arange(a.shape[i], device=a.device) * strides[i]
    local_base = base[mine] - a.row_start * strides[0]
    out = a_flat.new_zeros((a.shape[i], idx0.shape[0]))
    out[:, mine] = a_flat[local_base[None, :] + along[:, None]]
    return out


def cp_decompose(
    a,
    rank: int,
    iters: int = 25,
    seed: int = 0,
    method: str = "als",
    num_samples: int = 0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """CP: returns ``(weights: rank, factors)`` with
    ``factors[i].shape == (a.shape[i], rank)``, unit-norm columns, and
    weights descending, after a fixed ``iters`` sweeps.

    ``method='als'`` is exact alternating least squares (per sweep cost
    ~ d * prod(n) * rank); ``method='rand'`` is CPRAND -- fiber-sampled
    updates whose per-sweep cost is independent of prod(n)
    (``num_samples`` Khatri-Rao rows per update; default 4*rank + 64,
    clamped to the available fiber count).  A tensor stays on its
    device; any other array goes to the card; a DTensor sharded on mode
    0 is read block by block (the module docstring)."""
    a = _row_split(a)
    if len(a.shape) < 2:
        raise ValueError("cp_decompose needs a tensor of ndim >= 2")
    if method == "als":
        return _api(_cp_als_impl(a, seed, int(rank), int(iters)))
    if method == "rand":
        size = math.prod(a.shape)
        if size >= 2 ** 31:
            # the JAX package gathers by int32 index; this one by int64,
            # but keeps the JAX package's limit so the API matches
            raise ValueError(
                "method='rand' gathers fibers by flat int32 index; "
                f"prod(shape)={size} >= 2^31 would overflow -- decompose "
                "a sharded/reshaped view instead")
        s = int(num_samples) if num_samples else 4 * int(rank) + 64
        s = max(min(s, size // max(min(a.shape), 1)), int(rank))
        return _api(_cp_rand_impl(a, seed, int(rank), int(iters), s))
    raise ValueError(f"unknown method {method!r}")


def _api(result):
    """(weights, factors) with a row-split F_1 as its row-sharded
    DTensor."""
    weights, factors = result
    return weights, (_to_api(factors[0]),) + tuple(factors[1:])


def cp_reconstruct(weights, factors):
    """Sum of outer products back to the full tensor (sharded on mode 0
    where F_1 is row-sharded)."""
    kr = khatri_rao(list(factors[1:]))               # prod n_j x r
    view = from_dtensor(factors[0]) if is_dtensor(factors[0]) else None
    lead = (view.local if view else factors[0]) * weights[None, :]
    out = _mm(lead, kr.T).reshape([lead.shape[0]]
                                  + [f.shape[0] for f in factors[1:]])
    if view is None:
        return out
    return row_dtensor(out, view.mesh, view.rows, view.shape[0])
